"""mnist_rff — the paper's own workload: RFF kernel regression on MNIST-like
data, (sigma, q) = (5, 2000), c = 10 classes [paper §V-A]."""
from repro_torch.config import RFFConfig

RFF = RFFConfig(q=2000, sigma=5.0)
D_RAW = 784
N_CLASSES = 10
GLOBAL_MINIBATCH = 12000
N_CLIENTS = 30
