"""VINE3D project loader: Vine3DProject::loadProject in PyTorch.

PyTorch counterpart of ``criteria3d_tpu/vine3d_project.py``: loads a
vineyard project (the reference's ``VINE3D_test.ini`` layout;
bin/VINE3D/vine3DProject.cpp:100-211):

1. project ini + parameters.ini, DEM, soil map + soil DB, land-use map
   and stations, through :class:`criteria3d_tpu_torch.project.Criteria3DProject`
   (the reference shares the Project3D base class);
2. the VINE3D fields DB (``vine3d_db``): ``cultivar`` (PhenoVitis +
   Bindi-Miglietta + Wang-Leuning columns, loadGrapevineParameters,
   vine3DProject.cpp:240-263), ``training_system`` (loadTrainingSystems),
   ``fields`` (loadFieldsProperties, :584-633) and ``field_book``
   (loadFieldBook, :306-393: one operation per positive flag column, with
   the fixed trimming = 2.5 / leaf removal = 3.0 quantities);
3. the field map: the land-use raster carries ``id_field`` values; each DEM
   cell joins its field (setModelCasesMap, vine3DProject.cpp:470-531);
4. a :class:`criteria3d_tpu_torch.vine3d.Vine3DModel` over the shared 3-D
   water grid, built on the CUDA card unless ``initialize`` is given
   another device.

Loading is host work (sqlite3, numpy); the model's maps live on the device.
Without stations, :meth:`Vine3DProject.hourly_forcing` synthesizes a
clear-sky diurnal cycle.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sqlite3

import numpy as np
import torch

from criteria3d_tpu_torch.device import host_array
from criteria3d_tpu_torch.model import HourlyForcing, ModelConfig
from criteria3d_tpu_torch.physics import grapevine as gv
from criteria3d_tpu_torch.physics.vine_photosynthesis import WangLeuningParameters
from criteria3d_tpu_torch.project import Criteria3DProject
from criteria3d_tpu_torch.vine3d import (FieldBookEntry, FieldOperation,
                                         Vine3DModel)

__all__ = ["VineField", "Vine3DProject"]

# landuseNames (vine3DProject.cpp:42-49)
_VINEYARD_LANDUSES = {"VINEYARD", "VINEYARD_NEW"}


@dataclasses.dataclass
class VineField:
    """One row of the ``fields`` table (Crit3DModelCase,
    loadFieldsProperties / readFieldQuery, vine3DProject.cpp:534-633)."""

    id_field: int
    landuse: str = "UNDEFINED"
    id_cultivar: int = 0
    id_training_system: int = 0
    max_lai_grass: float = 1.0
    max_irrigation_rate: float = 0.0      # [mm h-1]

    @property
    def is_vineyard(self) -> bool:
        return self.landuse.upper() in _VINEYARD_LANDUSES


def _cultivar_from_row(row) -> tuple[gv.GrapevineParameters,
                                     WangLeuningParameters]:
    """DB column -> parameter mapping (loadGrapevineParameters,
    vine3DProject.cpp:240-263; alpha is scaled by 1e5 on load)."""
    g = gv.GrapevineParameters(
        critical_force_maturity=row["phenovitis_force_physiological_maturity"],
        leaf_d=row["miglietta_d"],
        leaf_f=row["miglietta_f"],
        fruit_biomass_offset=row["miglietta_fruit_biomass_offset"],
        fruit_biomass_slope=row["miglietta_fruit_biomass_slope"],
        co1=row["phenovitis_ecodormancy"],
        critical_chilling=row["phenovitis_critical_chilling"],
        critical_force_flowering=row["phenovitis_force_flowering"],
        critical_force_veraison=row["phenovitis_force_veraison"],
        critical_force_fruitset=row["phenovitis_force_fruitset"],
        degree_days_veraison=row["degree_days_veraison"])
    w = WangLeuningParameters(
        water_stress_threshold=row["hydrall_stress_threshold"],
        vpd_sensitivity=row["hydrall_vpd"],
        alpha=row["hydrall_alpha_leuning"] * 1.0e5,
        max_carbox_rate=row["hydrall_carbox_rate"])
    return g, w


@dataclasses.dataclass
class Vine3DProject:
    """A loaded VINE3D project (the Vine3DProject of the reference)."""

    base: Criteria3DProject
    cultivars: dict = dataclasses.field(default_factory=dict)
    trainings: dict = dataclasses.field(default_factory=dict)
    fields: dict = dataclasses.field(default_factory=dict)
    field_book: list = dataclasses.field(default_factory=list)
    compute_diseases: bool = True
    model: Vine3DModel | None = None
    field_map: np.ndarray | None = None

    # ------------------------------------------------------------------
    @classmethod
    def load(cls, ini_path: str, *, output_dir: str | None = None,
             meteo_db_path: str | None = None) -> "Vine3DProject":
        """Load the project ini, the base project's sources and the VINE3D
        fields DB (host work only)."""
        base = Criteria3DProject.load(ini_path, output_dir=output_dir,
                                      meteo_db_path=meteo_db_path)
        prj = cls(base=base, compute_diseases=base.config.compute_diseases)
        db_path = base.config.vine3d_db_path
        if db_path and os.path.exists(db_path):
            prj._load_vine_db(db_path)
        else:
            base.warnings.append("missing vine3d DB")
        return prj

    def _load_vine_db(self, db_path: str) -> None:
        con = sqlite3.connect(db_path)
        con.row_factory = sqlite3.Row
        try:
            for row in con.execute("SELECT * FROM cultivar"
                                   " ORDER BY id_cultivar"):
                self.cultivars[int(row["id_cultivar"])] = \
                    _cultivar_from_row(row)
            for row in con.execute("SELECT * FROM training_system"
                                   " ORDER BY id_training_system"):
                self.trainings[int(row["id_training_system"])] = \
                    gv.TrainingSystem(
                        id=int(row["id_training_system"]),
                        name=str(row["name"]),
                        shoots_per_plant=float(row["nr_shoots_plant"]),
                        row_width=float(row["row_width"]),
                        row_height=float(row["row_height"]),
                        row_distance=float(row["row_distance"]),
                        plant_distance=float(row["plant_distance"]))
            for row in con.execute(
                    "SELECT id_field, landuse, id_cultivar,"
                    " id_training_system, max_lai_grass,"
                    " irrigation_max_rate FROM fields ORDER BY id_field"):
                f = VineField(
                    id_field=int(row["id_field"]),
                    landuse=str(row["landuse"]),
                    id_cultivar=int(row["id_cultivar"]),
                    id_training_system=int(row["id_training_system"]),
                    max_lai_grass=float(row["max_lai_grass"]),
                    max_irrigation_rate=float(row["irrigation_max_rate"]))
                self.fields[f.id_field] = f
            self._load_field_book(con)
        finally:
            con.close()

    def _load_field_book(self, con) -> None:
        """One FieldBookEntry per positive operation flag
        (loadFieldBook, vine3DProject.cpp:306-393)."""
        for row in con.execute(
                "SELECT date_, id_field, irrigated, grass, pinchout,"
                " leaf_removal, harvesting_performed, cluster_thinning,"
                " tartaric_acid, irrigation_hours, thinning_percentage"
                " FROM field_book ORDER BY date_, id_field"):
            date = datetime.datetime.fromisoformat(str(row["date_"])).date()
            fid = int(row["id_field"])
            add = self.field_book.append
            if (row["irrigated"] or 0) > 0:
                add(FieldBookEntry(date, fid, FieldOperation.IRRIGATION,
                                   float(row["irrigation_hours"] or 0)))
            grass = int(row["grass"] or 0)
            if grass == 1:
                add(FieldBookEntry(date, fid, FieldOperation.GRASS_SOWING))
            elif grass > 1:
                add(FieldBookEntry(date, fid, FieldOperation.GRASS_REMOVING))
            if (row["pinchout"] or 0) > 0:
                add(FieldBookEntry(date, fid, FieldOperation.TRIMMING, 2.5))
            if (row["leaf_removal"] or 0) > 0:
                add(FieldBookEntry(date, fid, FieldOperation.LEAF_REMOVAL,
                                   3.0))
            if (row["harvesting_performed"] or 0) > 0:
                add(FieldBookEntry(date, fid, FieldOperation.HARVESTING))
            if (row["cluster_thinning"] or 0) > 0:
                add(FieldBookEntry(date, fid,
                                   FieldOperation.CLUSTER_THINNING,
                                   float(row["thinning_percentage"] or 0)))
            if (row["tartaric_acid"] or 0) > 0:
                add(FieldBookEntry(date, fid,
                                   FieldOperation.TARTARIC_ANALYSIS,
                                   float(row["tartaric_acid"])))

    # ------------------------------------------------------------------
    def initialize(self, *, dtype=torch.float64, fast: bool = False,
                   device=None) -> None:
        """Build the shared 3-D model, the field map and the vineyard model
        state (initialize3DModel + setModelCasesMap + initializeGrapevine,
        vine3DProject.cpp:167-205) on ``device``: None means the CUDA card.
        ``fast`` as :meth:`Criteria3DProject.initialize` takes it."""
        base = self.base
        base.initialize(dtype=dtype, fast=fast, device=device)
        grid, R_C = base.grid, base.dem.shape

        # field map: the land-units raster carries id_field values
        # (already resampled onto the DEM by the base load)
        fmap = np.full(R_C, -1, dtype=int)
        if base.land_unit_map is not None and self.fields:
            lm = np.asarray(base.land_unit_map)
            for fid in self.fields:
                fmap[np.isclose(lm, fid)] = fid
        elif self.fields:
            fmap[host_array(grid.mask[0])] = next(iter(self.fields))
        self.field_map = fmap

        vineyard = np.zeros(R_C, dtype=bool)
        for fid, f in self.fields.items():
            if f.is_vineyard:
                vineyard |= fmap == fid

        # the first vineyard field's cultivar and training system give the
        # canopy kernel's parameters (one lead cultivar per project)
        vine_fields = [f for f in self.fields.values() if f.is_vineyard] \
            or list(self.fields.values())
        lead = vine_fields[0] if vine_fields else VineField(0)
        g_params, wl_params = self.cultivars.get(
            lead.id_cultivar, (gv.GrapevineParameters(),
                               WangLeuningParameters()))
        training = self.trainings.get(lead.id_training_system)

        cfg = base.config
        mconfig = ModelConfig(
            latitude=cfg.latitude, longitude=cfg.longitude,
            timezone=cfg.time_zone if not cfg.is_utc else 0,
            clear_sky_transmissivity=cfg.clear_sky_transmissivity,
            linke=cfg.linke, albedo=cfg.albedo)
        psi0 = cfg.initial_water_potential \
            if cfg.is_initial_water_potential else -3.0
        self.model = Vine3DModel.create(
            grid, base.params, mconfig, matric_potential=psi0,
            vine_params=g_params, field_map=fmap,
            field_book=self.field_book, training=training)
        self.model.wang_leuning = wl_params
        self.model.compute_diseases = self.compute_diseases
        self.model.water_stress_threshold = wl_params.water_stress_threshold
        self.model.vineyard_mask = torch.as_tensor(vineyard,
                                                   device=grid.device)
        self.model.grass_lai = lead.max_lai_grass
        rates = [f.max_irrigation_rate for f in vine_fields
                 if f.max_irrigation_rate > 0]
        if rates:
            # the field's rate per irrigated hour (assignIrrigation,
            # modelCore.cpp:43-88)
            self.model.max_irrigation_rate = max(rates)

    # ------------------------------------------------------------------
    def hourly_forcing(self, when: datetime.datetime) -> HourlyForcing:
        """Station-interpolated forcing when stations were loaded, else a
        synthetic clear-sky diurnal cycle."""
        if self.base.stations:
            return self.base.hourly_forcing(when)
        shape = self.base.dem.shape
        h = when.hour + when.minute / 60.0
        t_air = 18.0 + 8.0 * np.sin(np.pi * (h - 9.0) / 12.0)
        rh = 75.0 - 25.0 * np.sin(np.pi * (h - 9.0) / 12.0)
        dev = self.base.grid.device

        def f(v):
            return torch.full(shape, float(v), dtype=torch.float64, device=dev)

        return HourlyForcing(
            air_temperature=f(t_air), precipitation=f(0.0),
            rel_humidity=f(np.clip(rh, 20.0, 100.0)),
            wind_speed=f(2.0), transmissivity=f(0.7))

    def run_day(self, date: datetime.date) -> dict:
        """One day of the vineyard daily cycle (Vine3DProject::runModels /
        modelDailyCycle, bin/VINE3D/modelCore.cpp:90-271)."""
        out = {}
        for hour in range(24):
            when = datetime.datetime(date.year, date.month, date.day, hour)
            forcing = self.hourly_forcing(when)
            out = self.model.run_hour(forcing, date.year, date.month,
                                      date.day, hour)
        day_out = self.model.daily_update(date)
        day_out["mbr"] = out.get("mbr")
        day_out["irrigation_mm"] = out.get("irrigation")
        return day_out
