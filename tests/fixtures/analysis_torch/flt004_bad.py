"""FLT004 fixture: the port's deprecated shims."""
from repro_torch.core.privacy import dp_sample_round
from repro_torch.launch import feature_dist


def run(*args):
    return dp_sample_round(*args), feature_dist
