"""PyTorch/CUDA port of the ThinkAir serving stack (the JAX package ``repro``
is the reference it is tested against).

The port mirrors the reference's module names and layout: ``configs``,
``models`` (spec, context, layers, blocks, model, weights), ``kernels``
(plain versions in ``ref``, hand-written CUDA kernels under ``csrc`` bound in
``ops``), ``core`` (clock, clones, dispatch, scheduler, venues, energy,
policy) and ``launch.serve`` (``LMBackend``, ``ClientHandler``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no such argument they raise instead of falling back to the CPU.
"""
