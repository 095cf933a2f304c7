"""Chain runner (`PocketSampler.sample_stacked`, the chain's set-up and
its graphs' lookup): the device-idle time inside the program's spans
`pf.sampler.tile`, `.probe`, `pf.chain.setup`, `pf.chain.graphs` and
`pf.sampler.split`, in ms, the mean over the traced calls.

Prints on stderr each phase's host and idle time, and the split of
`chain_host_ms.screen` into this metric, `chain_gap_ms.screen` and the
remainder: the idle of the benchmark's call outside those spans (its
generator and plan, outside the program's root span, and the program's
code between spans). The remainder is the idle outside both groups of
spans, so the sum falls short of `chain_host_ms.screen` by nothing
unless the two groups overlap: it checks that they partition the
call."""

from portbench import program_spans as ps


def read(run):
    value = ps.mean_idle_ms(run, ps.SAMPLER_PHASES)
    if value is None:
        return None
    ps.say("traced call by phase:")
    for line in ps.phase_table(run, ("sampler.call", *ps.SAMPLER_PHASES,
                                     "chain.capture", ps.CHAIN_RUN,
                                     "chain.replay", "chain.eager",
                                     "chain.fetch")):
        ps.say(line)
    gap = ps.mean_idle_ms(run, (ps.CHAIN_RUN,)) or 0.0
    rest, outside, inside = ps.remainder_ms(run)
    calls = [(b - a) - run.trace.busy(a, b)
             for _, (a, b) in ps.traced_calls(run)]
    host = 1e3 * sum(calls) / len(calls)
    ps.say(f"chain_host_ms.screen {host:.4f} = sampler_idle_ms.screen "
           f"{value:.4f} + chain_gap_ms.screen {gap:.4f} + remainder "
           f"{rest:.4f} (outside pf.sampler.call {outside:.4f}, between "
           f"its spans {inside:.4f}); the sum is off by "
           f"{value + gap + rest - host:+.6f} ms")
    ps.report_gaps(run)
    return value
