"""Paper-faithful small CNN for the ScaDLES convergence experiments.

The paper trains ResNet152 / VGG19 on CIFAR-10/100; for the CPU-scale
convergence reproduction we use a small conv net on synthetic 32x32x3
class-clustered data (DESIGN.md §8.2).  Not part of the assigned pool — used
only by the paper-validation benchmarks.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-cnn",
    family="cnn",
    num_layers=4,            # conv stages
    d_model=64,              # base channel width
    num_heads=1,
    num_kv_heads=1,
    d_ff=256,                # classifier hidden
    vocab_size=10,           # num classes
    citation="paper §V (ResNet152/VGG19 on CIFAR, CPU-scaled)",
)
