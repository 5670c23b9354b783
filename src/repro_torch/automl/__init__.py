"""The AutoML substrate in PyTorch: model families and the search engine."""
