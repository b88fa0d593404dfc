"""FAT quantization core: specs, calibration observers, the quant context."""
