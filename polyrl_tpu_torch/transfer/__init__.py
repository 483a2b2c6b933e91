"""Weight-transfer fabric: trainer -> rollout weight sync (a copy of
``polyrl_tpu/transfer``, sharing its wire and layout).

Layers:
- ``layout``     — flat name->(shape,dtype,offset) buffer layout, pack
                   (device to host) and install (host to device)
- ``tcp_engine`` — multi-stream TCP bulk transfer with CRC32 frames
- ``agents``     — sender (trainer side) / receiver (rollout side) with a
                   single JSON-over-TCP control channel
- ``interface``  — trainer facade (pack + version + signal); the colocated
                   path is the engine's own in-place copy
"""

from .agents import ReceiverAgent, SenderAgent, SenderGroup, TransferConfig
from .interface import TransferInterface, colocated_update
from .nic import filter_ips_by_cidr, get_node_ips, pick_sender_ips
from .layout import (
    ParamLayout,
    alloc_buffer,
    build_layout,
    pack_params,
    unflatten_like,
    unpack_params,
)
from .tcp_engine import TcpTransferEngine

__all__ = [
    "ParamLayout",
    "ReceiverAgent",
    "SenderAgent",
    "SenderGroup",
    "TcpTransferEngine",
    "TransferConfig",
    "TransferInterface",
    "alloc_buffer",
    "build_layout",
    "colocated_update",
    "filter_ips_by_cidr",
    "get_node_ips",
    "pack_params",
    "pick_sender_ips",
    "unflatten_like",
    "unpack_params",
]
