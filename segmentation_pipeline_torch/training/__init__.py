from .model import SegModel, to_channels_first, to_channels_last

__all__ = ["SegModel", "to_channels_first", "to_channels_last"]
