import sys

from ppsim_tpu_torch.harness import main

if __name__ == "__main__":
    sys.exit(main())
