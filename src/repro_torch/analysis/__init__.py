"""Analysis of the port: the static analyzer and the runtime sanitizer.

``python -m repro_torch.analysis`` (``__main__.py``) runs the port's
counterparts of the JAX package's checkers over ``src/repro_torch`` (rule
catalog in ``rules.py`` and ``docs/ANALYSIS_TORCH.md``, deliberate exceptions
in ``analysis_baseline_torch.json``):

  CK  cache-key completeness   HS  host syncs on the hot paths
  US  unit-suffix convention   KC  kernel coverage
  DC  docs

parsed, never imported, so the default run imports neither torch nor jax;
``--semantic`` adds the LG launch verifier, the DT dtype audit and the RC
build budget (``repro_torch.analysis.semantic``, imports torch). The
runtime sanitizer is ``repro_torch.analysis.sanitize``. Nothing here is
imported at package import: the kernel wrappers import ``sanitize``.
"""
