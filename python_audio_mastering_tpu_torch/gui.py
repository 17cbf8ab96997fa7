"""Desktop GUI: Tkinter client over the engine entry points.

Feature-parity with the reference GUI (mastering_gui.py): tabbed single-file
/ batch modes, the 13 parameter sliders with live value labels, the genre
preset dropdown (EQ_PRESETS re-export), a multiband section that shows when
enabled, threaded processing with a status bar, and completion detection on
the engine's message strings — plus the things the reference lacks: an
Automaster tab (pick a reference track → the differentiable chain solves
the saturation/EQ/width sliders to match it, the solved positions appear
live, and the track is mastered with them) and non-string-matched
completion (the engine returns success explicitly; the status-string
contract is still honoured for compatibility).

Counterpart of ``python_audio_mastering_tpu.gui`` over the port's engine:
every job runs on the card unless ``--device cpu`` is given.  Built on
plain ttk (no ttkthemes dependency); run with
``python -m python_audio_mastering_tpu_torch.gui [--device cpu]``.
"""

from __future__ import annotations

import argparse
import threading
import tkinter as tk
from tkinter import filedialog, messagebox, ttk

from python_audio_mastering_tpu_torch import engine
from python_audio_mastering_tpu_torch.gui_logic import (
    MB_SLIDERS,
    SLIDERS,
    GuiState,
)
from python_audio_mastering_tpu_torch.models.presets import EQ_PRESETS

__all__ = ["MasteringApp", "EQ_PRESETS", "SLIDERS", "MB_SLIDERS", "main"]


class MasteringApp(tk.Tk):
    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device
        self.title("GPU Audio Mastering")
        self.minsize(620, 700)
        self.vars = {}
        self.logic = GuiState()  # display-free state machine (gui_logic)

        nb = ttk.Notebook(self)
        nb.pack(fill="x", padx=12, pady=8)

        # --- single file tab ---
        single = ttk.Frame(nb, padding=8)
        nb.add(single, text="Single File")
        self.input_file = tk.StringVar()
        self.output_file = tk.StringVar()
        self._file_row(single, 0, "Select Input File", self.input_file,
                       self._pick_input)
        self._file_row(single, 1, "Select Output File", self.output_file,
                       self._pick_output)
        self.process_button = ttk.Button(single, text="Process Single File",
                                         command=self.start_single)
        self.process_button.grid(row=2, column=0, columnspan=2, sticky="ew",
                                 pady=8)
        single.columnconfigure(1, weight=1)

        # --- batch tab ---
        batch = ttk.Frame(nb, padding=8)
        nb.add(batch, text="Batch Processing")
        self.input_folder = tk.StringVar()
        self.output_folder = tk.StringVar()
        self._file_row(batch, 0, "Select Input Folder", self.input_folder,
                       lambda: self._pick_dir(self.input_folder))
        self._file_row(batch, 1, "Select Output Folder", self.output_folder,
                       lambda: self._pick_dir(self.output_folder))
        self.batch_button = ttk.Button(batch, text="Start Batch Process",
                                       command=self.start_batch)
        self.batch_button.grid(row=2, column=0, columnspan=2, sticky="ew",
                               pady=8)
        batch.columnconfigure(1, weight=1)

        # --- automaster tab: fit sliders to a reference track ---
        auto = ttk.Frame(nb, padding=8)
        nb.add(auto, text="Automaster")
        self.auto_input = tk.StringVar()
        self.auto_reference = tk.StringVar()
        self.auto_output = tk.StringVar()
        self._file_row(auto, 0, "Select Input File", self.auto_input,
                       lambda: self._pick_audio(self.auto_input,
                                                set_output=self.auto_output))
        self._file_row(auto, 1, "Select Reference Track", self.auto_reference,
                       lambda: self._pick_audio(self.auto_reference))
        self._file_row(auto, 2, "Select Output File", self.auto_output,
                       lambda: self._pick_save(self.auto_output))
        self.auto_button = ttk.Button(
            auto, text="Fit to Reference && Master",
            command=self.start_automaster)
        self.auto_button.grid(row=3, column=0, columnspan=2, sticky="ew",
                              pady=8)
        ttk.Label(auto, text="Fits saturation/EQ/width to the reference's "
                             "spectral profile, shows the solved sliders "
                             "live, then masters with them.",
                  wraplength=480).grid(row=4, column=0, columnspan=2,
                                       sticky="w")
        auto.columnconfigure(1, weight=1)

        # --- presets ---
        pf = ttk.LabelFrame(self, text="Presets", padding=8)
        pf.pack(fill="x", padx=12, pady=4)
        self.preset_var = tk.StringVar(value="None")
        ttk.OptionMenu(pf, self.preset_var, "None", "None",
                       *EQ_PRESETS.keys(),
                       command=self.apply_preset).pack(fill="x")

        # --- parameter sliders ---
        pframe = ttk.LabelFrame(self, text="Mastering Parameters", padding=8)
        pframe.pack(fill="x", padx=12, pady=4)
        for row, spec in enumerate(SLIDERS):
            self._slider(pframe, row, *spec)
        self.use_multiband = tk.BooleanVar(value=False)
        ttk.Checkbutton(pframe, text="Use Multiband Compressor",
                        variable=self.use_multiband,
                        command=self._toggle_mb).grid(
            row=len(SLIDERS), column=0, columnspan=3, sticky="w", pady=6)

        self.mb_frame = ttk.LabelFrame(self, text="Multiband Compressor",
                                       padding=8)
        for row, spec in enumerate(MB_SLIDERS):
            self._slider(self.mb_frame, row, *spec)

        # --- status bar ---
        self.status_var = tk.StringVar(value="Ready.")
        ttk.Label(self, textvariable=self.status_var, relief="sunken",
                  anchor="w", padding=4).pack(side="bottom", fill="x")

    # ------------------------------------------------------------------ UI
    def _file_row(self, parent, row, label, var, command):
        ttk.Button(parent, text=label, command=command).grid(
            row=row, column=0, sticky="ew", padx=4, pady=4)
        ttk.Label(parent, textvariable=var, wraplength=420).grid(
            row=row, column=1, sticky="w", padx=4)

    def _slider(self, parent, row, attr, label, lo, hi, default):
        ttk.Label(parent, text=label).grid(row=row, column=0, sticky="w")
        var = tk.DoubleVar(value=default)
        self.vars[attr] = var
        val = ttk.Label(parent, text=f"{default:.1f}", width=6)
        scale = ttk.Scale(parent, from_=lo, to=hi, variable=var,
                          orient="horizontal",
                          command=lambda v, lbl=val: lbl.config(
                              text=f"{float(v):.1f}"))
        scale.grid(row=row, column=1, sticky="ew", padx=8, pady=3)
        val.grid(row=row, column=2, sticky="w")
        var.trace_add("write",
                      lambda *_, v=var, lbl=val: lbl.config(
                          text=f"{v.get():.1f}"))
        parent.columnconfigure(1, weight=1)

    def _toggle_mb(self):
        if self.use_multiband.get():
            self.mb_frame.pack(fill="x", padx=12, pady=4)
        else:
            self.mb_frame.pack_forget()

    def _pick_input(self):
        path = filedialog.askopenfilename(
            filetypes=[("Audio Files", "*.wav *.mp3 *.flac *.aiff")])
        if path:
            self.input_file.set(path)
            if not self.output_file.get():
                from python_audio_mastering_tpu_torch.gui_logic import \
                    default_output_path

                self.output_file.set(default_output_path(path))

    def _pick_output(self):
        path = filedialog.asksaveasfilename(
            defaultextension=".wav",
            filetypes=[("WAV file", "*.wav"), ("MP3 file", "*.mp3")])
        if path:
            self.output_file.set(path)

    def _pick_audio(self, var, set_output=None):
        path = filedialog.askopenfilename(
            filetypes=[("Audio Files", "*.wav *.mp3 *.flac *.aiff")])
        if path:
            var.set(path)
            if set_output is not None and not set_output.get():
                from python_audio_mastering_tpu_torch.gui_logic import \
                    default_output_path

                set_output.set(default_output_path(path))

    def _pick_save(self, var):
        path = filedialog.asksaveasfilename(
            defaultextension=".wav",
            filetypes=[("WAV file", "*.wav"), ("MP3 file", "*.mp3")])
        if path:
            var.set(path)

    def _pick_dir(self, var):
        path = filedialog.askdirectory()
        if path:
            var.set(path)

    def apply_preset(self, name):
        self.logic.apply_preset(name)
        for k in ("bass_boost", "mid_cut", "presence_boost", "treble_boost"):
            self.vars[k].set(self.logic.values[k])

    # ------------------------------------------------------------ actions
    def _sync_logic(self):
        """Push widget values into the display-free state machine."""
        for attr, var in self.vars.items():
            self.logic.values[attr] = float(var.get())
        self.logic.multiband = bool(self.use_multiband.get())

    def get_current_settings(self) -> dict:
        self._sync_logic()
        return self.logic.get_current_settings()

    def _set_busy(self, busy: bool):
        state = "disabled" if busy else "normal"
        self.process_button.config(state=state,
                                   text="Processing..." if busy
                                   else "Process Single File")
        self.batch_button.config(state=state)
        self.auto_button.config(state=state,
                                text="Fitting..." if busy
                                else "Fit to Reference && Master")

    def start_single(self):
        self._sync_logic()
        settings, err = self.logic.start_single_job(self.input_file.get(),
                                                    self.output_file.get())
        if err:
            messagebox.showerror("Error", err)
            return
        self._set_busy(True)
        threading.Thread(target=engine.process_audio,
                         args=(settings, self.update_status),
                         kwargs={"device": self.device},
                         daemon=True).start()

    def start_batch(self):
        self._sync_logic()
        settings, err = self.logic.start_batch_job(self.input_folder.get(),
                                                   self.output_folder.get())
        if err:
            messagebox.showerror("Error", err)
            return
        self._set_busy(True)
        threading.Thread(target=engine.batch_process_audio,
                         args=(settings, self.input_folder.get(),
                               self.output_folder.get(), self.update_status),
                         kwargs={"device": self.device},
                         daemon=True).start()

    def start_automaster(self):
        self._sync_logic()
        settings, err = self.logic.start_automaster_job(
            self.auto_input.get(), self.auto_reference.get(),
            self.auto_output.get())
        if err:
            messagebox.showerror("Error", err)
            return
        self._set_busy(True)
        threading.Thread(target=self._run_automaster, args=(settings,),
                         daemon=True).start()

    def _run_automaster(self, settings):
        fitted = engine.automaster_audio(settings, self.update_status,
                                         device=self.device)
        if fitted:
            # marshal the solved slider positions onto the Tk main loop
            self.after(0, self._apply_fitted, fitted)

    def _apply_fitted(self, fitted: dict):
        applied = self.logic.apply_fitted_settings(fitted)
        for k, v in applied.items():
            self.vars[k].set(v)
        self.preset_var.set("None")

    def update_status(self, message: str):
        # Called from the worker thread; marshal onto the Tk main loop.
        self.after(0, self._apply_status, message)

    def _apply_status(self, message: str):
        self.status_var.set(message)
        kind = self.logic.on_status(message)
        if kind in ("done", "error", "empty"):
            self._set_busy(False)
            if kind == "done":
                messagebox.showinfo("Success", message)
            elif kind == "error":
                messagebox.showerror("Error", message)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python_audio_mastering_tpu_torch.gui")
    ap.add_argument("--device", default="cuda",
                    help="torch device the jobs run on (default: cuda)")
    MasteringApp(device=ap.parse_args(argv).device).mainloop()


if __name__ == "__main__":
    main()
