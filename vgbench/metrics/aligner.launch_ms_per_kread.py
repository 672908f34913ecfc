"""The POA problem arrays and their launches: ``aligner.build`` (query
codes, buckets, ``build_poa_batch_arrays``) and ``aligner.launch``
(``dispatch_bucket``: the host-to-device copies and kernel enqueues),
ms per thousand reads of the window."""

from vgbench.program import ms_per_kread


def read(record):
    return ms_per_kread(record, "aligner.build", "aligner.launch")
