"""The SPLIT model families: LGVae, LGGMVae and GMVae; SPAIR, BG-SPAIR,
LG-SPAIR and LGGlimpseSPAIR with their factory (split_vae_tpu/models)."""

from split_vae_torch.models.spair import (
    LGSPAIR,
    SPAIR,
    LGGlimpseSPAIR,
    SpairOutput,
    get_spair_model,
)
from split_vae_torch.models.vae import (
    GMVae,
    GMVaeOutput,
    LGGMVae,
    LGGMVaeOutput,
    LGVae,
    LGVaeOutput,
)
from split_vae_torch.nn.classifier import Classifier
