"""The remote user interface: packet wire, server, client, preview video
and the JPEG coder (counterparts of ``ipu_path_trace_tpu/ui``)."""

from .client import InterfaceClient
from .packetcomms import PACKET_TYPES, PacketDemuxer, PacketMuxer
from .server import InterfaceServer
