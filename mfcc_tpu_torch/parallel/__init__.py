"""Cross-utterance statistics (twins of mfcc_tpu.parallel)."""
