from .file_logger import FileLogger
from .logger import Logger
from .non_logger import NonLogger
from .wandb_logger import WandbLogger

__all__ = ["FileLogger", "Logger", "NonLogger", "WandbLogger"]
