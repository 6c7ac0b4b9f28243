"""Measurement and evaluation entry points of nori_tpu_torch, each run
as `python -m nori_tpu_torch.scripts.<name>` from the repository root:
`rmse_gate` (the matched-RMSE chain), `pathgraph_eval` (the path-graph
evaluation protocol), `pg_protocol_report` (its final report),
`ref_gates` (the reference's statistical fixtures) and `multicard` (the
sharded renderers on several cards)."""
