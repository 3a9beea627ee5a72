"""The JAX package's mesh scorers (ROADMAP A10a, A10b): the paired full
and incremental rescores, the device-resident paired state, the PacBio
forward and reduction, and the single-end forward over the staged cell
layout, each scoring one process's reads of a torch.distributed group
(distributed.py) or, without one, every read."""
