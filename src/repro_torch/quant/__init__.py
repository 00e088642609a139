"""Quantization of the port: the serving subset of ``repro.quant``."""
