"""The benchmark's general code: the runner of each traffic kind, the
device trace, the kernels' work and the result line (see ``run.py``)."""
