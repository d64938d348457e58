"""``python -m`` under the package's former name: the ``lia_ral`` CLI."""

import sys

from lia_ral.__main__ import main

if __name__ == "__main__":
    sys.exit(main())
