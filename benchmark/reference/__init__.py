"""The plain reference of the benchmark's cells: the port's eager,
host-looped water and coupled periods as they stood at commit 988b1ed,
before the CUDA graph machines, cut to the one path the cells run: the
float32 psi-carry step with the CG-line inner solver
(``SolverParameters.fast_f32``) and soil heat with vapor and chunk-frozen
properties, on one whole box. Plain PyTorch and NumPy: it imports nothing
of the port, of the JAX package or of JAX.

:mod:`benchmark.reference.storm` builds a cell's grid and initial state
from the DEM the benchmark hands it and runs the cell's period.
"""
