"""Each driver's traffic is the same for the same seed, differs across
seeds, and keeps its sizes across seeds."""
from __future__ import annotations

import numpy as np

from benchmark import songs


def test_songs_repeat_for_a_seed_and_differ_across_seeds():
    a = songs.make_songs([1.0, 0.5], 5, "cpu")
    b = songs.make_songs([1.0, 0.5], 5, "cpu")
    c = songs.make_songs([1.0, 0.5], 6, "cpu")
    assert [len(x) for x in a] == [16000, 8000]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


def test_annotations_repeat_for_a_seed_and_song():
    a = songs.annotation(2 ** 31 + 3, 4, 2.0)
    assert a.shape == (round(2 * songs.FRAME_RATE), 4)
    assert np.array_equal(a, songs.annotation(2 ** 31 + 3, 4, 2.0))
    assert not np.array_equal(a, songs.annotation(2 ** 31 + 4, 4, 2.0))
    assert not np.array_equal(a, songs.annotation(2 ** 31 + 3, 5, 2.0))
    assert a[:, 2].max() <= 4 and a[:, 3].max() <= 12


def test_serve_traffic():
    from benchmark.drivers import serve_songs
    from benchmark.tests import tiny

    traffic = tiny.overrides("lv60-serve-songs")["traffic"]
    traffic = dict(serve_songs_traffic(), **traffic)
    a, b, c = (serve_songs.draw(traffic, s, "cpu") for s in (7, 7, 8))
    assert a[1] == b[1] and all(np.array_equal(x, y)
                                for x, y in zip(a[0], b[0]))
    assert a[1] != c[1] and not np.array_equal(a[0][0], c[0][0])
    # the same requests in another order, of songs of the same lengths
    assert sorted(map(tuple, a[1])) == sorted(map(tuple, c[1]))
    assert [len(x) for x in a[0]] == [len(x) for x in c[0]]


def serve_songs_traffic():
    from benchmark import run

    return run.cell_spec("lv60-serve-songs")[2]


def test_train_traffic():
    from benchmark import run
    from benchmark.drivers import train_wav

    from benchmark.tests import tiny

    for over in ({}, tiny.TRAIN):
        traffic = run.cell_spec("lv60-train-5s", {"traffic": over})[2]
        a, b, c = (train_wav.draw_lengths(traffic, s) for s in (7, 7, 8))
        assert a == b and a != c or len(set(a)) == 1
        assert sorted(a) == sorted(c)
        lo, hi = traffic["song_seconds"]
        assert len(a) == traffic["song_count"] and lo <= min(a) <= max(a) <= hi


def test_serving_fixes_the_allocator_thresholds():
    """The serve traffic asks for glibc's fixed thresholds, and glibc takes
    them (``run.fix_malloc_thresholds``)."""
    from benchmark import run

    assert serve_songs_traffic()["fixed_malloc_thresholds"] is True
    assert run.fix_malloc_thresholds() is True
