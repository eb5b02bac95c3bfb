"""The paper's own architecture: Chameleon TCN presets (§IV).

Three published presets, identical to ``repro/configs/chameleon_tcn.py``:
  * FSL embedder — 14 layers / ~116k params (Omniglot, Table I)
  * raw-audio KWS — 24 layers / ~118k params, 16k-step inputs (§IV-C)
  * MFCC KWS — 8 layers / ~16.5k params (the 4x4 "always-on" mode model)
"""

from repro_torch.models.config import ArchConfig

CHAMELEON_TCN = ArchConfig(
    name="chameleon-tcn", family="tcn",
    # 14-layer FSL embedder: 7 residual blocks, receptive field 1525 >= 784
    tcn_kernel=7, tcn_channels=(32, 32, 32, 32, 32, 32, 32),
    tcn_in_channels=1, embed_dim=64, n_classes=5,
    n_layers=14, d_model=32, vocab_size=0, n_heads=1, n_kv_heads=1, d_ff=0,
)

CHAMELEON_TCN_AUDIO = CHAMELEON_TCN.replace(
    name="chameleon-tcn-audio",
    tcn_kernel=7, tcn_channels=(24,) * 12, n_layers=24, n_classes=12,
)

CHAMELEON_TCN_KWS = CHAMELEON_TCN.replace(
    name="chameleon-tcn-kws",
    tcn_kernel=3, tcn_channels=(24, 24, 24, 24), n_layers=8,
    tcn_in_channels=28, n_classes=12,
)

CONFIG = CHAMELEON_TCN
