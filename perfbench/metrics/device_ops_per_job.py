"""Device operations (kernels, copies, fills) per job in the traced stretch."""


def read(run):
    if run.stretch is None or not run.stretch.n_jobs:
        return None
    return len(run.stretch.ops) / run.stretch.n_jobs
