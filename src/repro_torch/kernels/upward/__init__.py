from .upward import upward_cuda, upward_launches, upward_plain

__all__ = ["upward_cuda", "upward_launches", "upward_plain"]
