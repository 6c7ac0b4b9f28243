import sys

from nori_tpu_torch.main import main

sys.exit(main())
