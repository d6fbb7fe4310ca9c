"""One closed-loop caller: statement i is drawn before its prove's clock
starts, and the next is sent once the last proof is back.  The window ends
at the first prove that completes after ``seconds``; a prove that raises
is a failure, with no claim and no proof, and the loop goes on."""

from portbench.loops import Record

KEYS = {"clients"}


def check(traffic):
    if traffic.get("clients") != 1:
        raise ValueError("the closed loop drives one caller; a mix of several callers names a loop of its own")


def drive(w):
    records, failed = [], 0
    t_start = w.clock()
    i = 0
    while True:
        st = w.statement(i)
        with w.span(f"portbench.prove#{i}"):
            t0 = w.clock()
            try:
                claim, proof = w.prove(st)
            except Exception:
                import traceback

                w.say(f"portbench: prove {i} failed:\n{traceback.format_exc()}")
                claim = proof = None
                failed += 1
            t1 = w.clock()
        records.append(Record(st, t1 - t0, claim, proof))
        i += 1
        if t1 - t_start >= w.seconds:
            return records, t1 - t_start, failed
