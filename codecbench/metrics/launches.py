"""launches.<family>: kernel launches a completed request, from the
program's ``launch.<kernel>`` counters taken under the traced run's
profiler (``program_trace``)."""

from codecbench import program_trace


def read(run):
    counts = program_trace.traced_counts(run)
    if not counts or not run.completed:
        return None
    launched = [n for name, n in counts.items() if name.startswith("launch.")]
    if not launched:
        return None
    return sum(launched) / len(run.completed)
