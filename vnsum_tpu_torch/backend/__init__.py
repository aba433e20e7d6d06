from .base import Backend, get_backend
from .engine import TorchBackend
from .fake import FakeBackend
from .ollama import OllamaBackend

__all__ = ["Backend", "get_backend", "FakeBackend", "OllamaBackend", "TorchBackend"]
