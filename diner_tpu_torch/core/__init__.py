from diner_tpu_torch.core.device import resolve_device
from diner_tpu_torch.core.types import EpiAnchors, RenderConfig, SceneEncoding

__all__ = ["EpiAnchors", "RenderConfig", "SceneEncoding", "resolve_device"]
