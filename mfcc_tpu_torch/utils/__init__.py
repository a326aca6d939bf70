"""Host-side utilities (twins of mfcc_tpu.utils)."""
