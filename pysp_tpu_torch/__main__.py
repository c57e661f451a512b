"""``python -m pysp_tpu_torch`` — forwards to the CLI (cli.py)."""
import sys

from .cli import main

sys.exit(main())
