"""Typed configs, the train state and the noise source of a stochastic forward."""

from split_vae_torch.core.config import ClassifierConfig, SpairConfig, VaeConfig
from split_vae_torch.core.state import TrainState, create_train_state
