"""The JAX package's mesh scorers on one device (ROADMAP A10a): the paired
full and incremental rescores, the device-resident paired state, the
PacBio forward and reduction, and the single-end forward over the staged
cell layout.  Multi-process sharding is ROADMAP A10b."""
