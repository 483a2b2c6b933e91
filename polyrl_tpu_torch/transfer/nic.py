"""NIC enumeration + CIDR selection for multi-interface weight transfer.

A copy of ``polyrl_tpu/transfer/nic.py``, except that no address here is
ever found by opening a socket towards an outside host: the advertised
default is the first non-loopback interface address, else loopback.

Equivalent of the reference's sender-IP selection
(``rlboost/weight_transfer/fsdp_interface.py:97-138``: enumerate node IPs,
filter by the ``allowed_sender_ips`` CIDR config, round-robin groups over
the surviving interfaces). Multi-NIC hosts only reach aggregate bandwidth
when each sender group binds a different interface — a single socket
rides one NIC.

Pure stdlib: interface addresses come from ``SIOCGIFADDR`` ioctls (Linux),
CIDR math from ``ipaddress``.
"""

from __future__ import annotations

import array
import ipaddress
import socket
import struct


def get_node_ips(include_loopback: bool = False) -> list[str]:
    """IPv4 addresses of all up interfaces on this host (reference
    ``get_node_ips``). Falls back to loopback on failure."""
    ips: list[str] = []
    try:
        import fcntl

        # SIOCGIFCONF: list interfaces (works without netlink/psutil)
        max_ifaces = 64
        bufsize = max_ifaces * 40
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            buf = array.array("B", b"\0" * bufsize)
            ifconf = struct.pack("iL", bufsize, buf.buffer_info()[0])
            out = fcntl.ioctl(s.fileno(), 0x8912, ifconf)  # SIOCGIFCONF
            nbytes = struct.unpack("iL", out)[0]
            data = bytes(buf[:nbytes])
        # each ifreq is 40 bytes on 64-bit linux: 16 name + sockaddr
        for off in range(0, nbytes, 40):
            ip = socket.inet_ntoa(data[off + 20 : off + 24])
            if not include_loopback and ip.startswith("127."):
                continue
            if ip not in ips:
                ips.append(ip)
    except (OSError, ImportError, ValueError):
        pass
    if not ips:
        ips = ["127.0.0.1"]
    return ips


def default_route_ip() -> str:
    """The address a sender advertises when none is configured: the first
    non-loopback interface address, else loopback. Read from the
    interface list only; no socket is opened towards another host."""
    for ip in get_node_ips(include_loopback=False):
        if not ip.startswith("127."):
            return ip
    return "127.0.0.1"


def filter_ips_by_cidr(ips: list[str], cidr_spec: str) -> list[str]:
    """Keep IPs inside any CIDR of the comma-separated ``cidr_spec``
    (reference ``filter_ips_by_config``). Empty/0.0.0.0/0 keeps all."""
    spec = (cidr_spec or "").strip()
    if not spec or spec == "0.0.0.0/0":
        return list(ips)
    nets = [ipaddress.ip_network(c.strip(), strict=False)
            for c in spec.split(",") if c.strip()]
    return [ip for ip in ips
            if any(ipaddress.ip_address(ip) in n for n in nets)]


def pick_sender_ips(num_groups: int, cidr_spec: str = "",
                    ips: list[str] | None = None) -> list[str]:
    """One bind/advertise IP per sender group: filtered node IPs,
    round-robined up to ``num_groups`` (reference fsdp_interface.py:108-115
    — fewer NICs than groups wraps around; more NICs truncates)."""
    node_ips = ips if ips is not None else get_node_ips(include_loopback=True)
    filtered = filter_ips_by_cidr(node_ips, cidr_spec)
    # advertising 127.0.0.1 to remote receivers is never useful when a real
    # interface matched the CIDR too (with the default open CIDR the bare
    # enumeration would otherwise put loopback first)
    non_loop = [ip for ip in filtered if not ip.startswith("127.")]
    if non_loop:
        filtered = non_loop
    if not filtered:
        raise RuntimeError(
            f"no node IP matches sender CIDR {cidr_spec!r} (node IPs: "
            f"{node_ips})")
    if len(filtered) < num_groups:
        filtered = (filtered * (num_groups // len(filtered) + 1))
    return filtered[:num_groups]
