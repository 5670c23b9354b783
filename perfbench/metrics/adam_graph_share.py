"""Share of the host's Adam steps replayed from a CUDA graph: per job, the
``graph_steps`` that ``models.adam_train`` adds to the open
``automl.rung.issue`` span over the job's ``adam_steps``, averaged over the
window's jobs that took a step.  None for a program that counts no
``graph_steps``."""
import numpy as np

from pbcore.spans import attr_per_job


def read(run):
    graph, steps = attr_per_job(run, "graph_steps"), attr_per_job(run, "adam_steps")
    if graph is None or steps is None:
        return None
    shares = [g / s for g, s in zip(graph, steps) if s > 0]
    return float(np.mean(shares)) if shares else None
