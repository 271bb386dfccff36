"""PyTorch/CUDA port of CodedFedL (``repro``) for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package runs the same main
path -- RFF embedding, the two-step deadline/load allocation, the batched
parity encode and the fused coded round of the flat batched engine -- in
PyTorch, with hand-written CUDA kernels for the three Pallas kernels on
that path (``repro_torch.kernels``).  It imports neither ``jax`` nor
``repro``.

    from repro_torch.api import ExperimentSpec, build_experiment
    result = build_experiment(spec, xs, ys).run(100)        # on the GPU
    result = build_experiment(spec, xs, ys, device="cpu").run(100)
"""
