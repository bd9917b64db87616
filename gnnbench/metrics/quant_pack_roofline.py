"""quant_pack_roofline: the least time of the quantized wires' work (bytes
over the card's bandwidth, ``counts.int2_wire_bytes`` over the rows each
quantized wire carries in the session's plan) over the device time of the
``quant_pack`` and ``dequant_unpack`` kernels, in the traced refresh
epochs."""

from gnnbench import counts


def read(ctx):
    pk = counts.peaks(ctx["device_kind"])
    refresh = [ep for ep in ctx["traced"] if ep["kind"] == "refresh"]
    busy = counts.kernel_seconds(refresh, ("quant_pack", "dequant_unpack"))
    wires = [w for w in ctx["facts"].get("wires", []) if w["bits"]]
    if pk is None or not busy or not wires:
        return None
    model, nparts = ctx["config"]["model"], ctx["facts"]["nparts"]
    work = sum(counts.int2_wire_bytes(model, w["rows_per_worker"] * nparts, w["bits"])
               for w in wires) * len(refresh)
    return 100.0 * work / pk["hbm_bytes_s"] / busy
