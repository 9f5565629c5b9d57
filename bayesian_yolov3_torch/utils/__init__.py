from .logging_utils import add_file_logging, setup_logging  # noqa: F401
