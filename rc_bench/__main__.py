import sys

from rc_bench.harness import main

sys.exit(main())
