"""paddle.distributed.launch (see main.py)."""
from .main import ELASTIC_EXIT_CODE, Pod, launch, main, parse_args  # noqa: F401
