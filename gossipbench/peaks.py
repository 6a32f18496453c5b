"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3, 700 W), the
yardstick every roofline share here is taken against.

HBM3 bandwidth and f32 arithmetic outside the tensor cores are the data
sheet's (3.35 TB/s, 67 TFLOP/s). The data sheet gives no 32-bit integer
rate: 64 INT32 lanes on each of the 132 SMs (H100 white paper) at the
1.98 GHz boost clock. Integer and f32 operations run on separate lanes,
so a bound by operations is the larger of the two types' times.
"""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bound(nbytes: float, int_ops: float, f32_ops: float) -> dict:
    """The least time of a piece of work: the larger of its bytes over
    the HBM rate and its operations over their rates."""
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = max(int_ops / INT32_OPS_PER_S, f32_ops / F32_OPS_PER_S)
    return {"bytes": nbytes, "int32_ops": int_ops, "f32_ops": f32_ops,
            "bound_s": max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s >= ops_s else "operations"}
