"""Open-loop load generator, run as a process of its own:

  python3 -m benchmark.yardstick.loadgen <schedule.json> <results.json>

The schedule holds the server's URL, the wall-clock time the window
starts, a per-request timeout and the requests as [offset_s, video path].
Each request is sent at its time whether or not earlier ones have finished
(POST /classify {"video": path}, one connection each, from a pool of
threads large enough that sending never waits on a reply) and timed from
when it was due. The results are [due, sent, done, HTTP status, body] a
request, wall-clock seconds; a request that got no reply has status 0 and
its error as the body. Only the standard library is imported.
"""

from __future__ import annotations

import concurrent.futures as cf
import http.client
import json
import sys
import time
import urllib.parse


def _send(url: str, path: str, timeout: float):
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        conn.request("POST", "/classify", body=json.dumps({"video": path}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def run(schedule: dict) -> list:
    url, start = schedule["url"], float(schedule["start_at"])
    timeout = float(schedule["timeout_s"])
    requests = schedule["requests"]
    out = [None] * len(requests)

    def one(i):
        due = start + requests[i][0]
        sent = time.time()
        try:
            status, body = _send(url, requests[i][1], timeout)
        except (OSError, http.client.HTTPException) as e:
            status, body = 0, f"{type(e).__name__}: {e}"
        out[i] = [due, sent, time.time(), status, body]

    with cf.ThreadPoolExecutor(max_workers=schedule["threads"]) as pool:
        futures = []
        for i, (offset, _) in enumerate(requests):
            wait = start + offset - time.time()
            if wait > 0:
                time.sleep(wait)
            futures.append(pool.submit(one, i))
        for f in futures:
            f.result()
    return out


def main(argv) -> int:
    with open(argv[0]) as f:
        schedule = json.load(f)
    results = run(schedule)
    with open(argv[1], "w") as f:
        json.dump(results, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
