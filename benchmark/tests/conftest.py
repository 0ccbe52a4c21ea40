import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for path in (HERE, os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))):
    if path not in sys.path:
        sys.path.insert(0, path)

import torch  # noqa: E402

torch.set_num_threads(2)  # test workers share the machine's cores
