"""A driver with none of the search's traffic, records or checks: it
decodes ``steps`` tokens on one session and reports one number, to show
that the harness asks a driver for nothing more than its interface."""
import time


class Driver:
    def __init__(self, cell, cfg, family, weights, model, seed, device, rec):
        self.t, self.model, self.seed, self.device = cell["traffic"], model, seed, device

    def setup(self):
        from repro_torch.serve import Engine, PagePool

        self.pool = PagePool(self.model.cfg, num_pages=16, page_size=4,
                             max_pages_per_session=8, device=self.device)
        self.eng = Engine(self.model, self.pool)
        self.sess = self.eng.new_session([self.seed % 100, 1, 2, 3])

    def window(self, seconds, trace):
        t0 = time.perf_counter()
        for _ in range(self.t["steps"]):
            self.eng.step([self.sess])
        return {"window_s": time.perf_counter() - t0, "spans": []}

    def collect(self):
        self.tokens = list(self.sess.tokens)

    def close(self):
        self.sess = self.eng = self.pool = self.model = None

    def check(self, reference, control):
        grown = len(self.tokens) - 5 - self.t["steps"]
        return {"numbers": {"tokens_missing": abs(grown), "control_tokens_missing": 1},
                "checks": {}, "attempted": self.t["steps"], "failed": 0,
                "info": {"tokens": len(self.tokens)}}
