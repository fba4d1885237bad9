"""The benchmark's general code: cells, traffic, spans, the device trace,
the kernels' counts and the comparison that decides ``correct``. Nothing
here names one configuration, traffic mix or per-layer metric: those are
files of their own under ``configs/``, ``traffic/`` and ``metrics/``."""
