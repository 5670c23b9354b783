"""Trials carried by one host-issued Adam step: the steps a trial by trial
run would issue (``trial_steps``) over the steps issued (``adam_steps``),
both summed over the window's ``automl.rung.issue`` spans."""
from pbcore.spans import attr_per_job


def read(run):
    steps, trial = attr_per_job(run, "adam_steps"), attr_per_job(run, "trial_steps")
    if steps is None or trial is None or sum(steps) <= 0:
        return None
    return sum(trial) / sum(steps)
