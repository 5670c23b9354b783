"""Share of the Gen-DST generations replayed from a CUDA graph: per job, the
sum of the ``gen_graphed`` attribute (1 where a graph's replay ran the
generation, 0 where it ran eagerly) over the number of the job's
``gen_dst.generation`` spans, averaged over the window's jobs that ran a
generation.  In ``manymodels.d1`` a job is a round, so its share counts the
generations of all its partitions' searches.  None for a program whose
generation spans carry no ``gen_graphed``."""
import numpy as np

from pbcore.spans import per_job


def read(run):
    jobs = per_job(run, "gen_dst.generation")
    if jobs is None or not any("gen_graphed" in sp["attrs"] for job in jobs for sp in job):
        return None
    shares = [sum(sp["attrs"].get("gen_graphed", 0) for sp in job) / len(job)
              for job in jobs if job]
    return float(np.mean(shares))
