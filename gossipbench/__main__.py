import sys

from gossipbench.run import main

sys.exit(main())
