from reference.core.device import resolve_device
from reference.core.types import EpiAnchors, RenderConfig, SceneEncoding

__all__ = ["EpiAnchors", "RenderConfig", "SceneEncoding", "resolve_device"]
