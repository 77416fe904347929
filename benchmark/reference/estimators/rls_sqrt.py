"""Square-root RLS, as the Grams it factors: G += v v' with v = [z; u],
then ridge^2 on the diagonal entry count mod d, count += 1; Q likewise
with z (its count read after G's increment); K_A += z+ v', barX += c z';
[A B] = K_A G^-1, C = barX Q^-1. The prior is G = I / c_ab, Q = I / c_c.

Every estimator module gives ``init(ref, batch)``, ``from_fields(ref,
fields)`` (a batch of program states given by their fields),
``model_of(ref, est)`` and ``observe(ref, est, z, u, z_next, c_target)``
(one observation, before the model guard)."""
import torch


def _outer(a, b):
    return a.unsqueeze(-1) * b.unsqueeze(-2)


def init(ref, batch):
    upd = ref.rc["update"]
    if upd["warm_start_from_batch"]:
        raise NotImplementedError("rls_sqrt warm start")
    d, nz = ref.nlift + ref.m, ref.nlift
    one = dict(K_A=torch.zeros(nz, d, **ref.kw),
               G=torch.eye(d, **ref.kw) / upd["c_ab"],
               barX=torch.zeros(ref.n, nz, **ref.kw),
               Q=torch.eye(nz, **ref.kw) / upd["c_c"])
    out = {k: t.expand((batch,) + t.shape) for k, t in one.items()}
    out["count"] = torch.zeros(batch, dtype=torch.int64, device=ref.kw["device"])
    return out


def from_fields(ref, fields):
    """The upper factors ``r_g``, ``r_q`` (G = r_g' r_g) or the Grams
    themselves, with ``K_A``, ``barX`` and ``count``."""
    cast = lambda t: t.to(**ref.kw)
    if "r_g" in fields:
        rg, rq = cast(fields["r_g"]), cast(fields["r_q"])
        grams = dict(G=rg.transpose(-1, -2) @ rg, Q=rq.transpose(-1, -2) @ rq)
    else:
        grams = dict(G=cast(fields["G"]), Q=cast(fields["Q"]))
    return dict(K_A=cast(fields["K_A"]), barX=cast(fields["barX"]),
                count=fields["count"].to(ref.kw["device"], torch.int64), **grams)


def model_of(ref, est):
    nz, mm = ref.nlift, ref.prec.mm
    k_ext = mm(est["K_A"], torch.linalg.inv(est["G"]))
    c = mm(est["barX"], torch.linalg.inv(est["Q"]))
    return k_ext[..., :nz], k_ext[..., nz:], c


def observe(ref, est, z, u, z_next, c_target):
    ridge = ref.rc["update"]["ridge"]
    v = torch.cat([z, u], dim=-1)

    def grow(gram, vec, count):
        gram = gram + _outer(vec, vec)
        if ridge > 0.0:
            idx = (count % gram.shape[-1]).reshape(-1, 1)
            e = torch.zeros(gram.shape[:-1], **ref.kw)
            e.scatter_(-1, idx.to(e.device), ridge)
            gram = gram + _outer(e, e)
        return gram

    return dict(K_A=est["K_A"] + _outer(z_next, v),
                barX=est["barX"] + _outer(c_target, z),
                G=grow(est["G"], v, est["count"]),
                Q=grow(est["Q"], z, est["count"] + 1),
                count=est["count"] + 1)
