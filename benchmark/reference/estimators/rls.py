"""RLS as Sherman-Morrison downdates of the inverse Grams, symmetrized
where the configuration says so: invG -= (invG v)(invG v)' / (1 + v'
invG v) with v = [z; u], barQ likewise with z; K_A += z+ v', barX += c
z'; [A B] = K_A invG, C = barX barQ. The prior is the batch fit's Grams
(``warm_start_from_batch``: K_A = Zy' V, invG = pinv(V' V), barX = X'
Zx, barQ = pinv(Zx' Zx)), else invG = c_ab I, barQ = c_c I."""
import torch


def _outer(a, b):
    return a.unsqueeze(-1) * b.unsqueeze(-2)


def init(ref, batch):
    upd, g = ref.rc["update"], ref.grams
    d, nz = ref.nlift + ref.m, ref.nlift
    if upd["warm_start_from_batch"]:
        one = dict(K_A=g["syv"], invG=ref.pinv(g["gvv"]),
                   barX=g["sxz"], barQ=ref.pinv(g["gzz"]))
    else:
        one = dict(K_A=torch.zeros(nz, d, **ref.kw),
                   invG=torch.eye(d, **ref.kw) * upd["c_ab"],
                   barX=torch.zeros(ref.n, nz, **ref.kw),
                   barQ=torch.eye(nz, **ref.kw) * upd["c_c"])
    return {k: t.expand((batch,) + t.shape) for k, t in one.items()}


def from_fields(ref, fields):
    return {k: fields[k].to(**ref.kw) for k in ("K_A", "invG", "barX", "barQ")}


def model_of(ref, est):
    nz, mm = ref.nlift, ref.prec.mm
    k_ext = mm(est["K_A"], est["invG"])
    c = mm(est["barX"], est["barQ"])
    return k_ext[..., :nz], k_ext[..., nz:], c


def observe(ref, est, z, u, z_next, c_target):
    mm, sym = ref.prec.mm, ref.rc["update"]["symmetrize"]
    v = torch.cat([z, u], dim=-1)

    def downdate(inv_g, vec):
        gv = mm(inv_g, vec.unsqueeze(-1)).squeeze(-1)
        denom = 1.0 + (vec * gv).sum(-1)
        out = inv_g - _outer(gv, gv) / denom[..., None, None]
        return 0.5 * (out + out.transpose(-1, -2)) if sym else out

    return dict(K_A=est["K_A"] + _outer(z_next, v),
                barX=est["barX"] + _outer(c_target, z),
                invG=downdate(est["invG"], v), barQ=downdate(est["barQ"], z))
