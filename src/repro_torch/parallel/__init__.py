"""Device-parallel evaluation of the port's batched grids
(``repro_torch.parallel.grid``)."""
