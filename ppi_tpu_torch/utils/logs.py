"""Run logging: to stderr and, for a result directory, to its ``log``."""

import logging
from pathlib import Path


def setup_logging(path=None, args=None):
    handlers = [logging.StreamHandler()]
    if path is not None:
        handlers.insert(0, logging.FileHandler(filename=Path(path) / "log",
                                               mode="w"))
    logging.basicConfig(
        handlers=handlers,
        format="%(asctime)s,%(msecs)d %(name)s %(levelname)s %(message)s",
        datefmt="%H:%M:%S", level=logging.INFO, force=True)
    if args is not None:
        for k, v in vars(args).items():
            logging.info("%s = %s", k, v)
