"""Mean over the window's queries of the bytes the engine sent to the
device for the query: the ``engine_stats`` deltas ``bytes_shipped``
(routing tables) plus ``store_upload_bytes`` (relation columns)."""
import statistics


def read(run):
    v = [a[2].engine_stats["bytes_shipped"]
         + a[2].engine_stats["store_upload_bytes"] for a in run.answers]
    return statistics.fmean(v) if v else None
