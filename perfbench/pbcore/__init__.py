"""The benchmark's own code: finding a cell's pieces by name (``spec``), the
tables and job pool (``tables``), one run (``cell``), the plain reference
and the comparison that decides ``correct`` (``reference``, ``compare``),
the profiler's reading (``profiling``), the yardstick's arithmetic
(``costs``), the result line (``output``) and the module check
(``modules``).  It imports nothing of the program but through the entry
adapters in ``perfbench/entries/``."""
