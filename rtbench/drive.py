"""The general generator: runs the program under a cell's traffic.

A traffic file names its ``kind``; :data:`GENERATORS` maps a kind to the
class that generates it.  Each generator builds the program's objects from the
benchmark's inputs in :meth:`setup` (set-up, warm-up included), runs the
measured window in :meth:`window`, profiles a few more units of work in
:meth:`profiled`, frees the program's state in :meth:`release`, and judges
what the window produced against :mod:`rtbench.reference` in
:meth:`check`.  The program is reached only through its entry points:
``rt_tpu_torch.scene``'s tables, ``rt_tpu_torch.renderer.create`` and
``rt_tpu_torch.train.make_kernel_train_step``.
"""

from __future__ import annotations

import math
import random
import sys
import time
import traceback

import torch
import torch.distributed as tdist

from . import counts as C
from . import inputs
from . import reference as R

def port_scene(arrays: dict, config: dict):
    """The benchmark's scene arrays as the program's ``Scene`` (CPU
    tensors, as the program's own loaders make them)."""
    from rt_tpu_torch.scene import Boxes, Camera, Materials, Planes, Scene, Spheres

    t = torch.from_numpy
    mats = Materials(type=t(arrays["mat_type"].copy()), albedo=t(arrays["albedo"].copy()),
                     roughness=t(arrays["roughness"].copy()),
                     reflectivity=t(arrays["reflectivity"].copy()), count=arrays["n_mat"],
                     names=tuple(f"m{i}" for i in range(arrays["n_mat"])))
    spheres = Spheres(center=t(arrays["center"].copy()), radius=t(arrays["radius"].copy()),
                      material=t(arrays["material"].copy()), count=arrays["n_spheres"])
    planes = Planes(normal=torch.zeros((8, 3)), d=torch.ones(8),
                    material=torch.zeros(8, dtype=torch.int32), count=0)
    boxes = Boxes(center=torch.full((8, 3), 1e9), extents=torch.zeros((8, 3)),
                  material=torch.zeros(8, dtype=torch.int32), count=0)
    camera = Camera.from_pose(arrays["camera_position"], arrays["camera_direction"],
                              vfov=inputs.VFOV, near=inputs.NEAR)
    return Scene(camera=camera, materials=mats, spheres=spheres, planes=planes, boxes=boxes,
                 samples_per_pixel=config["samples_per_pixel"],
                 max_bounces=config["max_bounces"], path=config["name"])


def _worst(values) -> float:
    """The largest of ``values``; infinite where one is not a number (a NaN
    compares false, so a plain ``max`` could pass it over)."""
    values = list(values)
    return math.inf if not values or any(math.isnan(v) for v in values) else max(values)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class Generator:
    """What the generators share: the cell's shapes, the inputs, the seed
    stream and the records of the window."""

    units_name = "units"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.size = tuple(config["resolution"])
        self.spp = config["samples_per_pixel"]
        self.depth = config["max_bounces"]
        self.n_pix = self.size[0] * self.size[1]
        self.rays_per_unit = self.n_pix * self.spp
        self.arrays = inputs.scene_arrays(config)
        self.seeds = inputs.SeedStream(seed)
        self.records = []          # per unit of the window: request, return, done (s)
        self.attempted = self.failed = 0
        self.window_s = 0.0
        self.profiled_seeds = []
        self.marks = [("inputs", time.perf_counter())]   # set-up phases, for the log

    def mark(self, phase: str):
        self.marks.append((phase, time.perf_counter()))

    def take_seed(self) -> int:
        return next(self.seeds)

    def cam(self):
        return R.camera_vector(self.arrays["camera_position"], self.arrays["camera_direction"],
                               self.size, inputs.VFOV, inputs.NEAR)

    def count_window(self, seconds: float):
        """Fix what the window will do before it opens (nothing here: the
        window runs until ``seconds`` have passed)."""

    def meet(self):
        """Wait for the other ranks on the host (one rank here: nothing)."""

    def report(self, peak: int, trace) -> dict:
        """What rank 0 needs of this rank once the profiled units are done:
        its peak device memory, the path of its trace, the forbidden
        modules it loaded and its units."""
        from .core import forbidden_modules

        return {"peak": int(peak), "trace": trace, "refused": forbidden_modules(),
                "units": len(self.records)}

    def reports(self, peak: int, trace) -> list:
        """Every rank's :meth:`report`, in rank order (one rank here)."""
        return [self.report(peak, trace)]

    def profiled_rank_work(self) -> list:
        """Each rank's :meth:`profiled_work`, in rank order (one rank here)."""
        return [self.profiled_work()]


class Frames(Generator):
    """A closed loop of frames through ``renderer.create(name)``: one
    client requests a frame, waits until it is complete on the device,
    then requests the next."""

    units_name = "frames"

    def setup(self):
        from rt_tpu_torch import renderer

        if (self.traffic["loop"], self.traffic["clients"]) != ("closed", 1):
            raise ValueError("the frames generator runs one client in a closed loop")
        self.scene = port_scene(self.arrays, self.config)
        self.render = renderer.create(f"{self.config['personality']}_{self.traffic['route']}")
        self.mark("program objects")
        for i in range(self.traffic.get("warmup", 2)):
            self._frame(self.take_seed())
            _sync(self.device)
            self.mark(f"warm-up frame {i}")
        self.kept = []              # (index, seed, frame), a reservoir drawn from the seed
        self.reservoir = random.Random(self.seed * 7919 + 1)

    def _frame(self, seed):
        return self.render(self.scene, self.size, seed=seed, spp=self.spp,
                           max_bounces=self.depth, device=self.device)

    def window(self, seconds: float):
        k = self.traffic["check"]["frames"]
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        clock = time.perf_counter
        t0 = clock()
        i = 0
        while clock() - t0 < seconds:
            seed = self.take_seed()
            self.attempted += 1
            t_req = clock()
            try:
                img = self._frame(seed)
            except Exception:  # a frame that raises is a failed frame
                print(f"rtbench: frame {i} (seed {seed}) raised:", file=sys.stderr)
                traceback.print_exc()
                self.failed += 1
                continue
            t_ret = clock()
            _sync(self.device)
            t_done = clock()
            self.records.append((t_req, t_ret, t_done))
            bad += (~torch.isfinite(img)).any()
            if len(self.kept) < k:
                self.kept.append((i, seed, img))
            else:
                j = self.reservoir.randrange(i + 1)
                if j < k:
                    self.kept[j] = (i, seed, img)
            i += 1
        _sync(self.device)
        self.window_s = (self.records[-1][2] if self.records else clock()) - t0
        self.failed += int(bad)

    def profiled(self, count: int):
        from torch.profiler import record_function

        for _ in range(count):
            seed = self.take_seed()
            self.profiled_seeds.append(seed)
            with record_function("rtbench: frame request"):
                self._frame(seed)
            with record_function("rtbench: waiting for the frame"):
                _sync(self.device)

    def release(self):
        self.scene = self.render = None

    def check(self):
        """The widest mean absolute gap, over the kept frames, between the
        returned frame and the reference at a pixel sample drawn from the
        seed."""
        tab = R.Tables(self.arrays, self.device)
        cam = self.cam()
        n = self.traffic["check"]["pixels"]
        gaps = []
        for i, seed, img in self.kept:
            pix = inputs.pixel_sample(self.n_pix, n, self.seed * 131 + i).to(self.device)
            ref = R.frame_pixels(tab, cam, self.size, self.spp, self.depth, seed, pix)
            got = img.reshape(-1, 3)[pix].to(torch.float64)
            gaps.append(float((got - ref.to(torch.float64)).abs().mean()))
        return [("frame_gap", _worst(gaps))]

    def profiled_work(self):
        """The live work of each profiled frame, counted by the reference."""
        tab = R.Tables(self.arrays, self.device)
        cam = self.cam()
        pix = torch.arange(self.n_pix, device=self.device)
        out = []
        for seed in self.profiled_seeds:
            cnt = R.new_counts()
            R.render_sums(tab, cam, self.size, self.depth,
                          R.frame_plan(seed, self.spp, self.n_pix), pix, cnt)
            out.append(C.frame_cost({k: int(v) for k, v in cnt.items()},
                                    self.arrays["n_spheres"], self.n_pix))
        return out


class Steps(Generator):
    """One training job: Adam steps of ``make_kernel_train_step``
    dispatched ahead, the host waiting only at the end of the window."""

    units_name = "steps"
    mesh = None

    def setup(self):
        from rt_tpu_torch.train import make_kernel_train_step

        tr = self.traffic
        if (tr["optimizer"], tr["dispatch"]) != ("adam", "ahead"):
            raise ValueError("the steps generator runs Adam with steps dispatched ahead")
        self.scene = port_scene(self.arrays, self.config)
        self.target = inputs.target_image(self.size, self.seed, self.device,
                                          tuple(tr["target_cells"]))
        _sync(self.device)
        self.mark("scene and target")
        m = self.arrays["albedo"].shape[0]
        self.p0 = torch.full((m, 4), tr["init"], dtype=torch.float32)
        self.params = {tr["param"]: self.p0.to(self.device).clone()}
        self.opt = torch.optim.Adam(list(self.params.values()), lr=tr["lr"],
                                    foreach=tr["foreach"])
        self.mark("optimizer")
        self.step = make_kernel_train_step(self.opt, self.scene, self.target, self.size,
                                           spp=self.spp, max_bounces=self.depth,
                                           personality=self.config["personality"],
                                           device=self.device, mesh=self.mesh)
        self.mark("program objects")
        # the first steps, through the window's own call: the warm-up, and
        # what the reference follows
        p = self.params[tr["param"]]
        self.check_seeds, self.losses = [], []
        for k in range(tr["check"]["steps"]):
            seed = self.take_seed()
            self.check_seeds.append(seed)
            self.losses.append(float(self.step(self.params, seed)))
            self.mark(f"step {k}")
            if k == 0:
                # the first gradient as Adam holds it: exp_avg = (1 - beta1) g
                m = self.opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                self.g1 = (m / (1.0 - self.opt.defaults["betas"][0])).cpu()
        self.p_after = p.detach().cpu().clone()
        _sync(self.device)

    def window(self, seconds: float):
        p = self.params[self.traffic["param"]]
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        clock = time.perf_counter
        t0 = clock()
        while clock() - t0 < seconds:
            seed = self.take_seed()
            self.attempted += 1
            t_req = clock()
            try:
                loss = self.step(self.params, seed)
            except Exception:  # a step that raises is a failed step
                print(f"rtbench: step (seed {seed}) raised:", file=sys.stderr)
                traceback.print_exc()
                self.failed += 1
                continue
            t_ret = clock()
            self.records.append((t_req, t_ret, None))
            bad += ~(torch.isfinite(loss) & torch.isfinite(p.grad).all())
        _sync(self.device)
        self.window_s = clock() - t0
        self.failed += int(bad)

    def profiled(self, count: int):
        from torch.profiler import record_function

        for _ in range(count):
            seed = self.take_seed()
            self.profiled_seeds.append(seed)
            with record_function("rtbench: step call"):
                self.step(self.params, seed)
        with record_function("rtbench: waiting for the steps"):
            _sync(self.device)

    def release(self):
        self.scene = self.step = self.opt = self.params = None

    def check(self):
        """The reference follows the first steps from the same start: for
        the first, every draw plan of the program's training routes, keeping
        the one whose loss lies nearest the program's (so a step of either
        route is judged as tightly); then the loss of each step, the norm of
        the first gradient and the norm of the change of the parameter."""
        tr = self.traffic
        n_steps = len(self.check_seeds)
        p = self.p0.to(torch.float64).to(self.device)
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        cam = self.cam()
        ref_losses, g1 = [], None
        self.plan = None
        for k, seed in enumerate(self.check_seeds):
            tab = R.Tables(self.arrays, self.device, albedo=p.cpu().numpy())
            if self.plan is None:
                best = None
                for name, plan in R.STEP_PLANS.items():
                    got = R.loss_and_grad(tab, cam, self.size, self.spp, self.depth,
                                          plan(seed, self.spp, self.n_pix), self.target)
                    gap = abs(got[0] - self.losses[0])
                    if best is None or gap < best[0]:
                        best = (gap, name, got)
                _, self.plan, (loss, grad) = best
            else:
                loss, grad = R.loss_and_grad(tab, cam, self.size, self.spp, self.depth,
                                             R.STEP_PLANS[self.plan](seed, self.spp, self.n_pix),
                                             self.target)
            ref_losses.append(loss)
            g = torch.zeros_like(p)
            g[:, :3] = grad
            if k == 0:
                g1 = g.clone()
            R.adam_update(p, g, m, v, k + 1, tr["lr"])
        loss_gap = _worst(abs(a - b) / abs(b) for a, b in zip(self.losses, ref_losses))
        gn_ref = float(g1.norm())
        grad_gap = _worst([abs(float(self.g1.double().norm()) - gn_ref) / gn_ref])
        du_ref = float((p.cpu() - self.p0.double()).norm())
        du = float((self.p_after.double() - self.p0.double()).norm())
        return [("loss_gap", loss_gap), ("grad_gap", grad_gap),
                ("update_gap", _worst([abs(du - du_ref) / du_ref]))]

    def profiled_work(self, first: int = 0, count: int = None):
        """The live work of each profiled step under the draw plan the
        check matched, counted by the reference (a path does not depend on
        the albedo), on the pixels ``first .. first + count - 1`` (all of
        them by default)."""
        tab = R.Tables(self.arrays, self.device)
        cam = self.cam()
        end = self.n_pix if count is None else max(first, min(self.n_pix, first + count))
        pix = torch.arange(first, end, device=self.device)
        plan = R.STEP_PLANS[self.plan or "per_sample"]
        out = []
        for seed in self.profiled_seeds:
            cnt = R.new_counts()
            R.render_sums(tab, cam, self.size, self.depth, plan(seed, self.spp, self.n_pix),
                          pix, cnt)
            out.append(C.step_cost({k: int(v) for k, v in cnt.items()},
                                   self.arrays["n_spheres"], end - first,
                                   self.arrays["albedo"].shape[0]))
        return out


def shard_pixels(total: int, ranks: int, rank: int, quantum: int = 128) -> tuple[int, int]:
    """The contiguous pixels a rank of the 'rays' axis traces: ``(first,
    count)``, every rank the same count, a multiple of ``quantum``; those at
    or past ``total`` are padding (the program's rule, worked out here
    again so that the counts of live work do not read the program)."""
    count = -(-(-(-total // quantum)) // ranks) * quantum
    return rank * count, count


class ShardedSteps(Steps):
    """The training job of :class:`Steps` over ``ranks`` processes, one a
    card, its rays sharded over the program's ('rays', 'prims') mesh: every
    rank builds the same scene, target, seed stream and Adam and takes the
    same steps; the program gathers the frame and sums the gradients
    inside each step.  The window's steps are counted out at the end of
    set-up, so that no collective of the benchmark's own falls inside it."""

    # steps timed at the end of set-up to count out the window's steps
    PROBE_STEPS = 8

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        self.ranks = traffic["ranks"]
        if self.ranks != math.prod(traffic["mesh"]):
            raise ValueError(f"a {traffic['mesh']} mesh does not hold {self.ranks} ranks")
        self.replica_gap = 0.0     # a stand-in in the program's place is one replica
        self.count = 0

    def setup(self):
        from rt_tpu_torch import dist

        self.device = dist.initialize(device=self.device.type)
        self.mesh = dist.make_mesh(*self.traffic["mesh"])
        # a group on the host alone, so that the ranks meet without a kernel
        self.host_group = tdist.new_group(backend="gloo")
        self.mark("world and mesh")
        super().setup()

    def meet(self):
        """Wait on the host until every rank is here: the profiled steps
        start together, whenever each rank's profiler began to record."""
        tdist.barrier(group=self.host_group)

    def count_window(self, seconds: float):
        """Time a few more steps, dispatched ahead and closed by a
        synchronize, and fix the window's steps at the count that fills
        ``seconds`` on rank 0's clock (broadcast to every rank)."""
        clock = time.perf_counter
        t0 = clock()
        for _ in range(self.PROBE_STEPS):
            self.step(self.params, self.take_seed())
        _sync(self.device)
        per_step = (clock() - t0) / self.PROBE_STEPS
        n = torch.tensor([max(1, round(seconds / per_step))], device=self.device)
        tdist.broadcast(n, 0)
        self.count = int(n.item())
        self.mark(f"{self.PROBE_STEPS} steps timed, {self.count} to the window")

    def window(self, seconds: float):
        """The counted steps, dispatched ahead; the window ends once every
        rank's card has finished them (a synchronize, then an all-reduce of
        the non-finite steps that every rank waits for)."""
        p = self.params[self.traffic["param"]]
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        clock = time.perf_counter
        t0 = clock()
        for _ in range(self.count):
            seed = self.take_seed()
            self.attempted += 1
            t_req = clock()
            loss = self.step(self.params, seed)
            self.records.append((t_req, clock(), None))
            bad += ~(torch.isfinite(loss) & torch.isfinite(p.grad).all())
        _sync(self.device)
        tdist.all_reduce(bad)
        self.failed += int(bad)
        self.window_s = clock() - t0

    def report(self, peak: int, trace) -> dict:
        rep = super().report(peak, trace)
        rep["losses"] = self.losses
        rep["albedo"] = self.params[self.traffic["param"]].detach().cpu()
        return rep

    def reports(self, peak: int, trace) -> list:
        """Every rank's report, gathered on every rank; rank 0 takes from
        them the largest gap between a rank's parameter and its own."""
        out = [None] * self.ranks
        tdist.all_gather_object(out, self.report(peak, trace))
        for r in out:
            r["gap"] = float((r["albedo"] - out[0]["albedo"]).abs().max())
        self.replica_gap = max(r["gap"] for r in out)
        return out

    def release(self):
        super().release()
        self.mesh = self.host_group = None
        if tdist.is_initialized():
            tdist.destroy_process_group()

    def check(self):
        """:meth:`Steps.check` on the whole frame, and ``replica_gap``: the
        widest gap between a rank's parameter and rank 0's after the window.
        The ranks take the same summed sums, but each assembles its
        gradient with float32 atomics of its own, so the replicas drift
        apart in their last bits; a rank that steps on other sums than the
        others lies far off."""
        return super().check() + [("replica_gap", self.replica_gap)]

    def profiled_rank_work(self) -> list:
        """The live work of the profiled steps on each rank's pixels."""
        return [self.profiled_work(*shard_pixels(self.n_pix, self.ranks, r))
                for r in range(self.ranks)]


GENERATORS = {"frames": Frames, "steps": Steps, "sharded_steps": ShardedSteps}
