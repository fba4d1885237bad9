"""The plain reference of the benchmark's comparison.

Frozen copies of the port's plain torch versions of the bootstrap level,
the per-frame program (pyramid, tracker, trace, the fused step) and the
keyframe path (activation, BA linearization and LM, point and frame
marginalization, seeding, the tracker reference).
Every dispatcher here calls the plain version on any device: no module of
this package imports the port, a kernel, JAX or the JAX package. The
comparison (``harness/check.py``) replays the program's captured calls with
these functions and measures how far the program's outputs lie from them.
"""
