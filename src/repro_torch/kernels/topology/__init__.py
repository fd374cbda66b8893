from .classify import level_classify_cuda, level_classify_plain

__all__ = ["level_classify_cuda", "level_classify_plain"]
