"""Plain PyTorch ops and the hand-written CUDA kernels (csrc/) that replace
the Pallas TPU kernels, each wrapper beside its plain version."""


def launch_counts() -> dict:
    """Each hand-written kernel's launch counter, by kernel name. A wrapper
    adds one where it launches its kernel and nowhere else; the plain
    versions count nothing."""
    from procyon_tpu_torch.ops import (activations, attention_rowblock,
                                       flash_attention, fused_decode,
                                       fused_mlp, int4_matmul, page_move,
                                       paged_attention)
    return {"rowblock_attention": attention_rowblock.launches,
            "fused_ln_mlp_int8": fused_mlp.launches,
            "ln_quant_rows": fused_mlp.launches_ln_quant,
            "fused_mlp_int8_prequant": fused_mlp.launches_prequant,
            "fused_rms_swiglu_int8": fused_mlp.launches_swiglu,
            "flash_attention_fwd": flash_attention.launches,
            "flash_attention_bwd_dq": flash_attention.launches_bwd_dq,
            "flash_attention_bwd_dkv": flash_attention.launches_bwd_dkv,
            "paged_attention": paged_attention.launches,
            "page_move": page_move.launches,
            "page_move_staged": page_move.launches_staged,
            "int4_matmul": int4_matmul.launches,
            "fused_decode_mlp": fused_decode.launches,
            "gelu_erf": activations.launches,
            "gelu_erf_bwd": activations.launches_bwd}


def launches_since(before: dict) -> dict:
    """launch_counts() less an earlier reading of it."""
    return {k: v - before[k] for k, v in launch_counts().items()}
