"""Architecture registry: --arch <id> resolves here (the reference's ten
architectures, field for field)."""
from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES, reduced

from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.grok_1_314b import CONFIG as _grok
from repro_torch.configs.whisper_medium import CONFIG as _whisper
from repro_torch.configs.h2o_danube_3_4b import CONFIG as _danube
from repro_torch.configs.mistral_nemo_12b import CONFIG as _nemo
from repro_torch.configs.qwen3_8b import CONFIG as _qwen3
from repro_torch.configs.phi3_mini_3_8b import CONFIG as _phi3
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba2
from repro_torch.configs.chameleon_34b import CONFIG as _chameleon

ARCHS = {c.name: c for c in [
    _moonshot, _grok, _whisper, _danube, _nemo,
    _qwen3, _phi3, _falcon, _zamba2, _chameleon,
]}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
