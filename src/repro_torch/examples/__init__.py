"""Runnable examples of the port (each ``python -m
repro_torch.examples.<name>``; ``--device cpu`` runs the kernels' plain
versions): ``quickstart`` (calibrate, FAT fine-tune, int8), ``serve_int8``
(the serve CLI and the Engine) and ``train_fat_qat`` (the §4.1.2
procedure with checkpoints)."""
