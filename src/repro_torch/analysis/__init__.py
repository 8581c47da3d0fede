"""Runtime analysis of the port: the opt-in NaN/index sanitizer
(``repro_torch.analysis.sanitize``)."""
