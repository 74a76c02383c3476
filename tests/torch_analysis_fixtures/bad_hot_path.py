"""host-sync violations in a fake dispatch/harvest loop, in each of
torch's spellings, plus one correctly-suppressed sync and one allow()
missing its justification."""

import torch


def drain_and_dispatch(batch, event, stream):
    if torch.any(batch > 0):                     # [viol:truthiness]
        total = float(batch.sum())               # [viol:float]
        first = batch[0].item()                  # [viol:item]
        rows = batch.tolist()                    # [viol:tolist]
        host = batch.cpu()                       # [viol:cpu]
        arr = host.numpy()                       # [viol:numpy]
        moved = batch.to("cpu")                  # [viol:to-cpu]
        moved_kw = batch.to(device="cpu")        # [viol:to-cpu-kw]
        torch.cuda.synchronize()                 # [viol:cuda-sync]
        event.synchronize()                      # [viol:event-sync]
        stream.synchronize()                     # [viol:stream-sync]
        ready = bool(torch.all(batch < 1.0))     # [viol:bool]
        count = int(torch.count_nonzero(batch))  # [viol:int]
        return total, first, rows, arr, moved, moved_kw, ready, count
    return 0.0, 0, [], None, None, None, False, 0


def harvest(ticket):
    # contract: allow(host-sync): harvest after the event; host memory
    good = ticket.numpy()                        # [ok:suppressed]
    # next line: allow() with no justification text -> still a finding
    bad = ticket.numpy()  # contract: allow(host-sync)
    return good, bad
