"""Plain float32 PyTorch reference of the served pipeline and the
renderer's train step.

A frozen copy of the port's Python (configuration dataclasses, the
preparation, LK backgrounds, the motion transformer, the SPADE
generator and mask net, the discriminators, VGG19, the losses and
AMSGrad), with each of the port's CUDA kernels replaced by plain
PyTorch (:mod:`.ops.norm`, :mod:`.ops.raster`), the data-parallel
hooks removed and nothing recomputed.  It imports nothing of the
program; weights come only from the flax trees the benchmark makes.
"""
