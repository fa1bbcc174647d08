"""CABAC context layout of the all-intra luma codec (HM-16.15 I-slice init
values, and the switch policy's PNNS flag context).

A frozen copy of the port's `codec/contexts.py` as the benchmark's plain
reference uses it (only the parts it needs; nothing of the port is
imported).
"""

from __future__ import annotations

from . import cabac


# I-slice luma init values.
INIT_SPLIT_CU = [139, 141, 157]


INIT_PART_SIZE = [184]


INIT_PREV_INTRA = [184]


INIT_CBF_LUMA = [111, 141]


INIT_TRANSFORM_SKIP = [139]


INIT_SIG_CG = [91, 171]


INIT_SIG = [111,
            111, 125, 110, 110, 94, 124, 108, 124,
            107, 125, 141, 179, 153, 125,
            107, 125, 141, 179, 153, 125,
            107, 125, 141, 179, 153, 125,
            141]


INIT_LAST_X = [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79]


INIT_LAST_Y = INIT_LAST_X


INIT_GREATER1 = [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107, 122, 152]


INIT_GREATER2 = [138, 153, 136, 167]


INIT_TRANS_SUBDIV = [153, 138, 138]


INIT_SAO_MERGE = [153]


INIT_SAO_TYPE = [200]


# Chroma context sets (I-slice rows of ContextTables.h; CNU = 154).
INIT_CHROMA_PRED = [63]


INIT_CBF_CHROMA = [94, 138, 182, 154, 154]        # ctx = relative TU depth


INIT_SIG_CHROMA = [140,
                   139, 182, 182, 152, 136, 152, 136, 153,
                   136, 139, 111,
                   136, 139, 111,
                   111]


INIT_LAST_X_CHROMA = [108, 123, 63] + [154] * 12


INIT_LAST_Y_CHROMA = INIT_LAST_X_CHROMA


INIT_GREATER1_CHROMA = [140, 179, 166, 182, 140, 227, 122, 197]


INIT_GREATER2_CHROMA = [152, 152]


INIT_TRANSFORM_SKIP_CHROMA = [139]


INIT_SIG_CG_CHROMA = [134, 141]


# PNNS flag context for the "switch" codec behaviour (hm_16_15_switch
# ContextTables.h:239-247: init value 154 for every slice type).
INIT_PNNS_FLAG = [154]


class Offsets:
    pass


def _build_layout():
    names = [
        ("split_cu", INIT_SPLIT_CU),
        ("part_size", INIT_PART_SIZE),
        ("prev_intra", INIT_PREV_INTRA),
        ("cbf_luma", INIT_CBF_LUMA),
        ("transform_skip", INIT_TRANSFORM_SKIP),
        ("sig_cg", INIT_SIG_CG),
        ("sig", INIT_SIG),
        ("last_x", INIT_LAST_X),
        ("last_y", INIT_LAST_Y),
        ("greater1", INIT_GREATER1),
        ("greater2", INIT_GREATER2),
        ("pnns_flag", INIT_PNNS_FLAG),
        ("trans_subdiv", INIT_TRANS_SUBDIV),
        ("sao_merge", INIT_SAO_MERGE),
        ("sao_type", INIT_SAO_TYPE),
        ("chroma_pred", INIT_CHROMA_PRED),
        ("cbf_chroma", INIT_CBF_CHROMA),
        ("sig_chroma", INIT_SIG_CHROMA),
        ("last_x_chroma", INIT_LAST_X_CHROMA),
        ("last_y_chroma", INIT_LAST_Y_CHROMA),
        ("greater1_chroma", INIT_GREATER1_CHROMA),
        ("greater2_chroma", INIT_GREATER2_CHROMA),
        ("transform_skip_chroma", INIT_TRANSFORM_SKIP_CHROMA),
        ("sig_cg_chroma", INIT_SIG_CG_CHROMA),
    ]
    offsets = Offsets()
    init_values = []
    pos = 0
    for name, vals in names:
        setattr(offsets, name, pos)
        init_values.extend(vals)
        pos += len(vals)
    return offsets, init_values


OFFSETS, INIT_VALUES = _build_layout()


NUM_CONTEXTS = len(INIT_VALUES)


def make_context_states(qp: int) -> np.ndarray:
    """Fresh per-slice context state array for the given QP."""
    return cabac.init_contexts(qp, INIT_VALUES)

