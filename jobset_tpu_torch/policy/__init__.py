"""The learned placement policy's device programs: the MLP scorer
(`model`) and its full-batch trainer (`train`,
`python -m jobset_tpu_torch.policy.train`), with the corpus builder
(`dataset`) and the feature schema (`features`) they need."""

from .features import FEATURE_DIM, FEATURE_NAMES, DomainHistory
from .model import CheckpointError, PolicyMLP, PolicyModel, load_checkpoint, save_checkpoint, score

__all__ = [
    "CheckpointError",
    "DomainHistory",
    "FEATURE_DIM",
    "FEATURE_NAMES",
    "PolicyMLP",
    "PolicyModel",
    "load_checkpoint",
    "save_checkpoint",
    "score",
]
