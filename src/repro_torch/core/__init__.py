"""Physics and selection layer of the port: devices, bitcells, retention,
periphery, macro geometry, characterization, and the selection policy."""
