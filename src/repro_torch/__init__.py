"""repro_torch: the gain-cell memory compiler on PyTorch and CUDA.

A port of the JAX package ``repro`` that imports neither ``jax`` nor
``repro``. Two slices so far:

- the nominal compiler flow: physics (``core``) -> ``characterize_batch``
  -> ``api.DesignTable`` -> ``api.explore`` (the paper's Table 2), with the
  retention transient in the CUDA kernel of ``kernels/csrc/retention.cu``;
- hymba-1.5b serving (``models``, ``serve``, ``launch.serve``): prefill with
  decode caches and batched decode, with the global-attention prefill in
  ``kernels/csrc/flash_attention.cu`` and the SSM prefill scan in
  ``kernels/csrc/ssm_scan.cu``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see ``repro_torch.device``).
"""
