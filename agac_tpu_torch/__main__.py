import sys

from .cmd.root import main

sys.exit(main())
