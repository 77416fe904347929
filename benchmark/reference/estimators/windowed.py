"""The sliding window of the last W observations and the exact ridge
least squares over it.

The state is four rings of W rows, ``zx`` (the lifted states), ``u``,
``zy`` (the lifted next states) and ``x`` (the output targets), and the
cursor ``count``. The prior holds the last W training snapshots (fewer
where there are fewer, zeros after them), the cursor at their number mod
W. Each observation overwrites the row under the cursor and advances it
mod W. The model, with V = [Zx U] and the ridge floored at 1e-5:

    [A B]' = (V'V + ridge I)^-1 V'Zy,    C' = (Zx'Zx + ridge I)^-1 Zx'X,

each solved directly. How a program keeps that model fresh (carried Grams
and inverses, Sherman-Morrison, a Newton-Schulz polish) is its mechanism,
not these semantics, so the comparison's ``model`` numbers hold the
program's model to this one and measure how far its carried inverses
drift."""
import torch

RINGS = ("zx", "u", "zy", "x")


def init(ref, batch):
    w = ref.rc["update"]["window"]
    rows = (ref.lift(ref.x), ref.u, ref.lift(ref.y), ref.x)
    take = min(w, rows[0].shape[0])

    def ring(r):
        out = torch.zeros((w,) + r.shape[1:], **ref.kw)
        out[:take] = r[r.shape[0] - take:]
        return out.expand((batch,) + out.shape)

    out = {k: ring(r) for k, r in zip(RINGS, rows)}
    out["count"] = torch.full((batch,), take % w, dtype=torch.int64,
                              device=ref.kw["device"])
    return out


def from_fields(ref, fields):
    """The program's rings and its write cursor ``idx``."""
    out = {k: fields[k].to(**ref.kw) for k in RINGS}
    out["count"] = fields["idx"].to(ref.kw["device"], torch.int64)
    return out


def model_of(ref, est):
    nz, mm = ref.nlift, ref.prec.mm
    ridge = max(ref.rc["update"]["ridge"], 1e-5)
    zx, u, zy, x = (est[k] for k in RINGS)
    v = torch.cat([zx, u], dim=-1)
    vt, zt = v.transpose(-1, -2), zx.transpose(-1, -2)
    eye = lambda k: torch.eye(k, **ref.kw)
    # solve_ex raises on no input: a singular or non-finite window gives a
    # non-finite model, which the model guard holds back
    k_ext = torch.linalg.solve_ex(mm(vt, v) + ridge * eye(v.shape[-1]),
                                  mm(vt, zy))[0].transpose(-1, -2)
    c = torch.linalg.solve_ex(mm(zt, zx) + ridge * eye(nz),
                              mm(zt, x))[0].transpose(-1, -2)
    return k_ext[..., :nz], k_ext[..., nz:], c


def observe(ref, est, z, u, z_next, c_target):
    w = ref.rc["update"]["window"]
    at = (torch.arange(z.shape[0], device=z.device), est["count"])
    out = {}
    for k, row in zip(RINGS, (z, u, z_next, c_target)):
        ring = est[k].clone(memory_format=torch.contiguous_format)
        ring[at] = row
        out[k] = ring
    out["count"] = (est["count"] + 1) % w
    return out
