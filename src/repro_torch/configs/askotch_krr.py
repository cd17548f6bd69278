"""The paper's own production workload: full KRR on taxi-scale data — the
port's copy of ``repro.configs.askotch_krr`` (same values).

n = 1e8 rows, d = 9 features, RBF kernel (sigma=1), lam_unscaled = 2e-7,
blocksize b = n/2000 = 50_000, rank r = 100 — the §6.2 showcase settings.
The dry run traces one distributed ASkotch iteration on the production meshes
(rows over ("pod","data") x block rows over "model").
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class KRRRunConfig:
    name: str = "askotch-krr-taxi-100m"
    n: int = 100_000_000
    d: int = 9
    kernel: str = "rbf"
    sigma: float = 1.0
    lam_unscaled: float = 2e-7
    block_size: int = 50_000
    rank: int = 100
    rho_mode: str = "damped"
    accelerated: bool = True


def config() -> KRRRunConfig:
    return KRRRunConfig()


def reduced() -> KRRRunConfig:
    return dataclasses.replace(
        config(), name="askotch-krr-smoke", n=4096, d=9, block_size=256, rank=32
    )
