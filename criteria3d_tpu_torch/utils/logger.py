"""Project logger: file + console logging.

The port's own copy of ``criteria3d_tpu/utils/logger.py``, line for line (host
numpy and the standard library). The logger is named
``criteria3d_tpu_torch.<name>``, so both packages can log in one process.

Analogue of the reference's logger (agrolib/utilities/logger.cpp +
Project::setLogFile/logInfo/logError, agrolib/project/project.cpp:236-242):
a dated log file under a log directory, timestamped lines, mirrored to the
console. Python's logging module is the idiomatic carrier.
"""

from __future__ import annotations

import datetime
import logging
import os
import sys

__all__ = ["ProjectLogger"]


class ProjectLogger:
    """File+console logger with the reference's naming scheme:
    ``<logDir>/<project>_<yyyyMMdd_HHmm>.log`` (logger.cpp setLog)."""

    def __init__(self, name: str = "criteria3d"):
        self.name = name
        self._logger = logging.getLogger(f"criteria3d_tpu_torch.{name}")
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        self._file_handler = None
        if not self._logger.handlers:
            console = logging.StreamHandler(sys.stdout)
            console.setFormatter(logging.Formatter("%(message)s"))
            self._logger.addHandler(console)

    def set_log_file(self, log_dir: str, project_name: str = "") -> str:
        """Open a dated log file (Logger::setLog). Returns its path."""
        os.makedirs(log_dir, exist_ok=True)
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M")
        base = project_name or self.name
        path = os.path.join(log_dir, f"{base}_{stamp}.log")
        if self._file_handler is not None:
            self._logger.removeHandler(self._file_handler)
            self._file_handler.close()
        self._file_handler = logging.FileHandler(path)
        self._file_handler.setFormatter(
            logging.Formatter("%(asctime)s  %(message)s",
                              datefmt="%Y-%m-%d %H:%M:%S"))
        self._logger.addHandler(self._file_handler)
        return path

    def info(self, msg: str) -> None:
        """logInfo (project.h:236)."""
        self._logger.info(msg)

    def error(self, msg: str) -> None:
        """logError (project.h:238): prefixed like the reference."""
        self._logger.error("ERROR! %s", msg)

    def warning(self, msg: str) -> None:
        self._logger.warning("WARNING: %s", msg)

    def close(self) -> None:
        if self._file_handler is not None:
            self._logger.removeHandler(self._file_handler)
            self._file_handler.close()
            self._file_handler = None
