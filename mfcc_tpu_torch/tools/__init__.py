"""Measurement tools for the port's kernels, run on a machine with a card
(``python -m mfcc_tpu_torch.tools.<name>``); nothing here runs on import."""
