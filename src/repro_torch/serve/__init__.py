# Online inference over the trained model, on the card:
#   egonet — k-hop ego-net extraction (exact or fanout-sampled)
#   cache  — staleness-controlled remote-feature cache (the cd knob)
#   spec   — ServeSpec, the RunSpec-style declarative deployment
#   server — block-diagonal batched bucketed-ELL serving
from repro_torch.serve.cache import FeatureCache
from repro_torch.serve.egonet import EgoNet, extract_ego, remote_frontier, sample_neighbors
from repro_torch.serve.server import GNNServer, ServeError, ShapeLadder, build_server
from repro_torch.serve.spec import ServeConfig, ServeSpec, is_serve_spec_dict

__all__ = [
    "EgoNet",
    "FeatureCache",
    "GNNServer",
    "ServeConfig",
    "ServeError",
    "ServeSpec",
    "ShapeLadder",
    "build_server",
    "extract_ego",
    "is_serve_spec_dict",
    "remote_frontier",
    "sample_neighbors",
]
