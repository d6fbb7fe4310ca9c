import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch

# several test workers share the machine's cores
torch.set_num_threads(min(2, torch.get_num_threads()))
