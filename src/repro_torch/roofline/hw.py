"""Target hardware constants: one NVIDIA H100 80GB HBM3, SXM board, at its
full 700 W power limit (NVIDIA's data sheet, dense rates without sparsity).

The counterpart of ``repro.roofline.hw``, whose TPU constants do not carry
over.  A card set below 700 W (``nvidia-smi --query-gpu=power.limit``) runs
slower under load, so a share of these peaks is stated with the card's
name and power limit beside it.

The production meshes of the dry run (``launch/mesh.py``) keep the
reference's sizes: 16 x 16 (256 cards) and 2 x 16 x 16 (512).  Their
collective term uses one bandwidth, that of the slowest link any axis of
those meshes crosses: a 16-wide axis spans two 8-GPU NVLink domains, so
its traffic leaves the node on each GPU's own inter-node port.  NVIDIA's
DGX H100 data sheet gives one 400 Gb/s ConnectX-7 port per GPU: 50 GB/s.
"""

NAME = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700.0

#: f32 on the CUDA cores: the f32 policy's rate (TF32 stays off)
PEAK_FLOPS_F32 = 67e12
#: dense bf16 on the tensor cores: what the bf16 policy could reach
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12  # bytes/s
HBM_BYTES = 80e9  # a card's memory: the dry run's "fits" limit

#: special-function results a second (ex2, sqrt): 16 a clock on each of the
#: 132 SMs at the 1.98 GHz boost clock (NVIDIA's Hopper white paper), 1/8
#: of the f32 rate
SM_COUNT = 132
SFU_RESULTS_S = SM_COUNT * 16 * 1.98e9

#: the production meshes' card counts (the reference's)
SINGLE_POD_CHIPS = 256
MULTI_POD_CHIPS = 512
#: bytes/s a GPU sends to another node: one 400 Gb/s ConnectX-7 port per
#: GPU (NVIDIA DGX H100 data sheet), the slowest link a 16-wide axis crosses
COLLECTIVE_BW = 400e9 / 8
