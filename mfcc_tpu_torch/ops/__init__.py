"""Feature stages in plain PyTorch, one module per stage of mfcc_tpu.ops."""
