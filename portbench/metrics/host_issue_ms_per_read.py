"""Host ms enqueuing one host read, per read: the self time of
`ldpc.fer.issue` (the graph's replay, the launch counts, the mesh sum, the
copy to pinned memory behind its event), that is its host ms less that of
the `ldpc.fer.capture` spans nested in it.  Read in a traced run only, so
it includes what the profiler (CUPTI) adds to each launch, `cudaGraphLaunch`
the most; the untraced issue time is smaller."""

from portbench import spans


def read(ctx):
    issue = spans.ms_per("ldpc.fer.issue", "ldpc.fer.issue")
    capture = spans.ms_per("ldpc.fer.capture", "ldpc.fer.issue")
    if issue is None or capture is None:
        return None
    return issue - capture
