"""Model assembly for the attention + dense-MLP architectures: shared
layers, GQA attention (prefill through the flash kernel, decode through
the paged kernel), the layer stack, and conversion of the reference's
parameter pytrees."""
from repro_torch.models.model import (decode_step, forward, init_decode_state,
                                      init_params, lm_loss)

__all__ = ["decode_step", "forward", "init_decode_state", "init_params",
           "lm_loss"]
