from .engine import EngineConfig, InferenceEngine, Request  # noqa: F401
from .server import Server, ServerStats  # noqa: F401
