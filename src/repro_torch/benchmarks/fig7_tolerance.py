"""Fig. 7: GSS tolerance ε vs solver latency/ILP-solve count vs E_Total.

Claims: iterations ≈ 5n+1 for ε=10⁻ⁿ (Eq. 7); ε=0.01 is the sweet spot.

Re-derived as scenarios: one zero-duration scenario per ε running the
unguarded Algorithm-1 GSS (the paper's configuration) through the engine;
each row is the scenario's initial ProvisioningDecision."""

from ..core import expected_iterations
from ..sim import ClusterSim, Scenario

from . import common


def scenario(eps: float, max_offerings: int = 2000) -> Scenario:
    return Scenario(
        name=f"fig7_eps{eps:g}", duration_hours=0.0,
        pods=100, cpu_per_pod=2, mem_per_pod=2,
        policy="kubepacs_unguarded", tolerance=eps,
        interrupt_model="none", catalog_seed=0, max_offerings=max_offerings,
    )


def run(cat=None):
    cat = cat or common.catalog()
    rows = []
    for n in (1, 2, 3, 4):
        eps = 10.0 ** -n
        res = ClusterSim(scenario(eps, max_offerings=len(cat)),
                         catalog=cat).run()
        _, decision = res.decisions[0]
        rows.append({
            "eps": eps,
            "ilp_solves": decision.trace.ilp_solves,
            "predicted_iters": expected_iterations(eps),
            "wall_s": decision.trace.wall_seconds,
            "e_total": decision.metrics["e_total"],
        })
    base = max(r["e_total"] for r in rows)
    for r in rows:
        r["e_ratio"] = r["e_total"] / base
    return {"rows": rows, "us_per_call": rows[1]["wall_s"] * 1e6}


def main():
    out = run()
    detail = ";".join(
        f"eps={r['eps']:g}:solves={r['ilp_solves']}"
        f"(pred~{r['predicted_iters']})"
        f",t={r['wall_s']:.2f}s,E={r['e_ratio']:.4f}" for r in out["rows"])
    print(f"fig7_tolerance,{out['us_per_call']:.0f},{detail}")
    return out


if __name__ == "__main__":
    main()
