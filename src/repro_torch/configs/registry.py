"""Architecture registry: ``--arch <id>`` resolution, for the architectures
the port serves so far."""
from repro_torch.configs import qwen2_5_3b

ARCHS = {
    "qwen2.5-3b": qwen2_5_3b.CONFIG,
}


def get_config(name: str):
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(ARCHS)}; "
                       "the rest of the reference's zoo comes in later "
                       "slices") from None
