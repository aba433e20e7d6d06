from .ring import ring_attention
from .seq import SeqGroup

__all__ = ["SeqGroup", "ring_attention"]
