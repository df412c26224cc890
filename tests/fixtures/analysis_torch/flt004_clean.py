"""FLT004 fixture, clean twin: the replacements."""
from repro_torch.core import fed
from repro_torch.core.privacy import DPConfig


def run(per_sample_loss, params, data, key):
    return fed.sample_round(per_sample_loss, params, data, key, 8,
                            dp=DPConfig())
