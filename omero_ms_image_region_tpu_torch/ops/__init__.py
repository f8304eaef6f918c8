"""Device ops: quantize, render composites, flip, LUT registry."""
