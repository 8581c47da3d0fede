"""repro_torch: the gain-cell memory compiler on PyTorch and CUDA.

A port of the JAX package ``repro`` that imports neither ``jax`` nor
``repro``. Slices so far:

- the compiler flow at any operating corner: physics (``core``) ->
  ``characterize_batch`` / ``characterize_corners`` -> ``api.DesignTable``
  -> ``api.explore`` (the paper's Table 2; ``robust="worst_case"``), with
  the retention transient in the CUDA kernel of
  ``kernels/csrc/retention.cu`` (one launch per corner);
- the heterogeneous composer ``hetero.compose``: N-level compositions
  scored on the device, exhaustive or branch-and-bound, with budgets and
  the (vdd, refresh-margin) sweep;
- the trace-replay re-rank ``sim`` (``compose(refine="simulate")``,
  ``api.simulate``), replayed as tensor code on the device;
- the rest of the compiler façade: ``api.Compiler``, the ``Macro``
  emitters (netlist, floorplan with DRC/LVS, Verilog, Liberty, LEF) and
  ``gradient_size_macro`` by ``torch.autograd``;
- hymba-1.5b serving (``models``, ``serve``, ``launch.serve``): prefill with
  decode caches and batched decode, with the global-attention prefill in
  ``kernels/csrc/flash_attention.cu`` and the SSM prefill scan in
  ``kernels/csrc/ssm_scan.cu``;
- hymba-1.5b training (``LM.loss``, ``optim``, ``train``, ``data``,
  ``checkpoint``, ``runtime``, ``launch.train``), with the two kernels'
  gradients in ``kernels/csrc/flash_attention_bwd.cu`` and
  ``kernels/csrc/ssm_scan_bwd.cu``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see ``repro_torch.device``).
"""
