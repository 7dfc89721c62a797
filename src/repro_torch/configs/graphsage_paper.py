"""The paper's own architecture (§4): 3-layer GraphSAGE, hidden 256,
fanouts (15, 10, 5) — the config that exercises FastSample end to end
(counterpart of ``repro.configs.graphsage_paper``)."""
from repro_torch.models.gnn import GNNConfig

# ogbn-products-shaped (Table 1: 100 features, 47 classes)
PRODUCTS = GNNConfig(in_dim=100, hidden_dim=256, num_classes=47,
                     num_layers=3, fanouts=(15, 10, 5), dropout=0.5)

# ogbn-papers100M-shaped (Table 1: 128 features, 172 classes)
PAPERS = GNNConfig(in_dim=128, hidden_dim=256, num_classes=172,
                   num_layers=3, fanouts=(15, 10, 5), dropout=0.5)


def reduced() -> GNNConfig:
    """Reduced smoke variant."""
    return GNNConfig(in_dim=16, hidden_dim=32, num_classes=5, num_layers=2,
                     fanouts=(4, 3), dropout=0.0)
