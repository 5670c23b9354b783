"""Training: optimizers and schedules (``optimizer``) and the train and serve
step builders (``train_step``), after the JAX package's ``train/``."""
