"""``correct`` comes out false when the timed path is broken underneath:
a run driven past the harness's look for a card, on the CPU at scale 10,
with the system under test replaced by a broken one.  The control (the
reference in bfloat16 in the program's place) must fail too."""
import pytest
import torch

from portbench import control, harness, program, ref

SEED = 2**31 + 5


def broken(fault):
    def entry(traffic, csr):
        call = program.entry(traffic, csr)

        def wrapped(sources):
            labels, rounds = call(sources)
            return fault(labels, sources, traffic), rounds
        return wrapped
    return entry


def unchanged(labels, sources, traffic):
    """A step that returns its state as it came in."""
    if traffic["app"] == "pagerank":
        return torch.full_like(labels, 1.0 / labels.shape[-1])
    out = torch.full_like(labels, ref.INF)
    rows = out.reshape(-1, out.shape[-1])
    for r, s in enumerate(sources):
        rows[r, s] = 0
    return out


def half_batch(labels, sources, traffic):
    """Half of the batch's rows left out."""
    out = labels.clone()
    out[labels.shape[0] // 2:] = ref.INF
    return out


def altered(labels, sources, traffic):
    """One answer altered where it is produced."""
    out = labels.clone()
    flat = out.reshape(-1)
    if traffic["app"] == "pagerank":
        flat[0] += 1e-3
    else:
        reached = torch.nonzero(flat < ref.INF).flatten()
        flat[reached[-1]] += 1
    return out


CASES = [("kron26-sssp", unchanged), ("kron26-sssp", altered),
         ("urand26-sssp", unchanged), ("urand26-sssp", altered),
         ("kron26-sssp-b8", unchanged), ("kron26-sssp-b8", half_batch),
         ("kron26-sssp-b8", altered),
         ("kron26-pr", unchanged), ("kron26-pr", altered)]


@pytest.mark.parametrize("workload", ["kron26-sssp", "urand26-sssp",
                                      "kron26-sssp-b8", "kron26-pr"])
def test_sound_run_is_correct(tiny_root, workload):
    out = harness.run(workload, SEED, 0.3, False, "cpu", 0.0, tiny_root)
    assert out["correct"] and out["failed"] == 0


def one_buffer(entry):
    """A program that hands out one label buffer for every answer."""
    def make(traffic, csr):
        call, held = entry(traffic, csr), []

        def wrapped(sources):
            labels, rounds = call(sources)
            if not held:
                held.append(labels.clone())
            held[0].copy_(labels)
            return held[0], rounds
        return wrapped
    return make


@pytest.mark.parametrize("workload", ["kron26-sssp", "kron26-sssp-b8"])
def test_a_reused_answer_buffer_stays_correct(tiny_root, workload):
    out = harness.run(workload, SEED, 0.3, False, "cpu", 0.0, tiny_root,
                      entry=one_buffer(program.entry))
    assert out["correct"] and out["failed"] == 0


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__}" for w, f in CASES])
def test_fault_is_caught(tiny_root, workload, fault):
    out = harness.run(workload, SEED, 0.3, False, "cpu", 0.0, tiny_root,
                      entry=broken(fault))
    assert out["correct"] is False
    assert out["failed"] >= 1


# urand's distances at a size a test run holds all lie under 256 (122 at
# scale 10, 198 at 14), where bfloat16 is exact, so its control fails
# only at the cell's own size, where it is run on the card.
@pytest.mark.parametrize("workload", ["kron26-sssp", "kron26-sssp-b8",
                                      "kron26-pr"])
def test_control_is_not_correct(tiny_root, workload):
    out = harness.run(workload, SEED, 0.3, False, "cpu", 0.0, tiny_root,
                      entry=control.entry)
    assert out["correct"] is False
