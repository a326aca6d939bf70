"""Model-level pipelines (twins of mfcc_tpu.models)."""
