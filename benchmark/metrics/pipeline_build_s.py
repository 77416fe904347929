"""pipeline_build_s (s): the harness's clock around ``run.build_pipeline``
(the snapshots, the lift, the EDMD fit, the estimator, moved to the card)."""


def read(rec):
    return rec.get("pipeline_build_s")
