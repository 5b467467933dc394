from .file_logger import FileLogger
from .logger import Logger
from .non_logger import NonLogger

__all__ = ["FileLogger", "Logger", "NonLogger"]
