"""PyTorch/CUDA port of the nomad_tpu placement solver.

Imports neither `jax` nor anything of `nomad_tpu`: the host-side modules
it needs (structs, feasibility checks, tensorizer) are kept as copies.
"""
