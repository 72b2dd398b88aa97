"""groot-gnn: the paper's own architecture — GraphSAGE node classification
over partitioned EDA graphs (the 11th dry-run arch; port of
``repro/zoo/configs/groot_gnn.py``).

Not a ModelConfig (it is not an LM); exposes the same registry surface:
``config()`` returns a GrootConfig consumed by ``launch/dryrun.py``'s
dedicated GNN step builder (``launch/steps.py:build_groot_cell``).
"""
import dataclasses

from repro_torch.core.gnn import GNNConfig


@dataclasses.dataclass(frozen=True)
class GrootConfig:
    name: str = "groot-gnn"
    family: str = "gnn"
    dataset: str = "csa"
    bits: int = 64               # dry-run design size (per-device subgraphs)
    batch: int = 16              # paper's large-batch setting
    num_partitions: int = 256    # one partition per device
    gnn: GNNConfig = dataclasses.field(default_factory=lambda: GNNConfig(hidden=128))
    skip_shapes: tuple = ()


ARCH_ID = "groot-gnn"


def config() -> GrootConfig:
    return GrootConfig()


def smoke_config() -> GrootConfig:
    return GrootConfig(bits=8, batch=2, num_partitions=2, gnn=GNNConfig(hidden=16))
