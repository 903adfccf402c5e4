import sys

from fipm_bench.run import main

sys.exit(main())
