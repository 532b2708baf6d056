"""Optimizers of the training path: AdamW with its cosine schedule, and
int8 error-feedback compression of the data-parallel gradient all-reduce."""

from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     cosine_schedule, global_norm)
from repro_torch.optim.compress import (compress_int8, decompress_int8,
                                        ef_compress_grads)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "compress_int8", "decompress_int8",
           "ef_compress_grads"]
